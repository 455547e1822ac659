"""Serving: the LLM replica (``llm.LLMServerImpl``) and the request-level
batcher ``batch`` (``batching.py``)."""

from ray_tpu_torch.serve.batching import batch

__all__ = ["batch"]
