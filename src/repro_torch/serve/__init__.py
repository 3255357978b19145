"""Serving of the port: the LM engine (``engine``) and the solver
telemetry (``metrics``); the solver engines wait for a later slice."""
