"""Fleet (counterpart: ``paddle_tpu/distributed/fleet``). Only
``meta_parallel.sharding`` is ported; the rest of fleet (the strategy, the
meta-parallel layers, pipeline and recompute) is ROADMAP Queue 1 item 6."""
