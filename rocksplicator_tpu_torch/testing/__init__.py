"""Test/chaos instrumentation that ships inside the production package —
the port's own copy of ``rocksplicator_tpu/testing`` (its own armed-site
table; ``RSTPU_FAILPOINTS`` arms both packages' copies at import).

``failpoints`` is the deterministic fault-injection registry threaded
through every I/O and RPC seam; it is a strict no-op unless activated via
API or the ``RSTPU_FAILPOINTS`` env var, so production paths pay one
module-global boolean check per site.
"""

from . import failpoints  # noqa: F401
