"""counter_service — the canonical application.
(The port's copy of ``examples/counter_service/__init__.py``.)

Reference: examples/counter_service/ — a thrift ``Counter extends Admin``
service (get/set/bump with a ``need_routing`` server-side routing flag),
``CounterHandler extends AdminHandler``, a ``CounterRouter`` over the shard
-map router, the uint64-add merge operator, per-segment storage options,
and a stress-test load generator.
"""
