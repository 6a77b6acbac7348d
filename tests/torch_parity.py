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


# the JAX package's compaction counters that the port emits at the same
# sites (its own Stats singleton)
G1_COUNTERS = ("compaction.subcompactions", "compaction.stream_chunks",
               "compaction.stream_refills", "compaction.stream_merges",
               "compaction.stream_declines")


def counters(stats_module, names=G1_COUNTERS) -> dict:
    """The counters of ``names`` in one package's Stats singleton."""
    st = stats_module.Stats.get()
    return {n: st.get_counter(n) for n in names}


def span_shape(collector_module, prefixes=("",), timed=()) -> dict:
    """One package's kept spans whose names start with one of
    ``prefixes``, as a multiset: (name, parent's name, sorted
    annotations, error class) -> count; a parent outside the selected
    spans counts as none. Ids and times are left out, annotations named
    in ``timed`` (host-clock durations) too, so two packages' traces of
    the same job compare equal."""
    spans = [s for s in collector_module.SpanCollector.get().snapshot()
             if s["name"].startswith(tuple(prefixes))]
    names = {s["span_id"]: s["name"] for s in spans}
    shape: dict = {}
    for s in spans:
        key = (s["name"], names.get(s["parent_id"]),
               tuple(sorted((k, v) for k, v in s["annotations"].items()
                            if k not in timed)),
               (s["error"] or "").split("(")[0])
        shape[key] = shape.get(key, 0) + 1
    return shape


def reset_observability(*packages, sample_rate: float = 1.0) -> None:
    """Zero each package's Stats, empty its span collector (keeping every
    root at ``sample_rate``) and disarm its failpoints; ``packages`` are
    the top modules (``rocksplicator_tpu``, ``rocksplicator_tpu_torch``)."""
    import importlib

    for pkg in packages:
        name = pkg.__name__
        importlib.import_module(name + ".utils.stats").Stats.reset_for_test()
        col = importlib.import_module(name + ".observability.collector")
        col.SpanCollector.reset_for_test()
        col.SpanCollector.get().configure(sample_rate=sample_rate)
        importlib.import_module(name + ".testing.failpoints").reset_for_test()
