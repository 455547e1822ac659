from ray_tpu_torch.ops.ring_attention import ring_attention  # noqa: F401
