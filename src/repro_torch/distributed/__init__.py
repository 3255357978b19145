"""Multi-device helpers of the port, as ``repro.distributed``: gradient
compression so far (sharding and pipelining wait for ROADMAP Queue 1
step 12)."""
