"""LM serving: the engine's prefill / decode / chunked-prefill steps and
per-request ``generate``. The continuous-batching scheduler comes later."""
