"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: the same numpy inputs go through both, outputs come back as numpy
and must be equal element for element (integer lanes: tolerance 0)."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from rocksplicator_tpu_torch.models.compaction_model import FORWARD_ARGS
from rocksplicator_tpu_torch.ops.lanes import lanes_from_numpy, lanes_to_numpy


def jax_args(batch):
    return tuple(jnp.asarray(batch[k]) for k in FORWARD_ARGS)


def torch_args(batch, device="cpu"):
    lanes = lanes_from_numpy({k: batch[k] for k in FORWARD_ARGS}, device)
    return tuple(lanes[k] for k in FORWARD_ARGS)


def jax_out(out) -> dict:
    res = {}
    for k, v in out.items():
        a = np.asarray(v)
        res[k] = a.item() if a.ndim == 0 else a
    return res


def torch_out(out) -> dict:
    return lanes_to_numpy(out)


def assert_same_outputs(want: dict, got: dict, what: str = "") -> None:
    assert set(want) == set(got), (what, sorted(want), sorted(got))
    for k in want:
        w, g = want[k], got[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), (what, k)
            assert w.dtype == g.dtype, (what, k, w.dtype, g.dtype)
            np.testing.assert_array_equal(w, g, err_msg=f"{what} {k}")
        else:
            assert type(g) is type(w) and g == w, (what, k, w, g)
