try:  # registers SyntheticAtari-v0 with gymnasium when available
    from ray_tpu_torch.rllib.env import synthetic_atari  # noqa: F401
except ImportError:  # pragma: no cover - gym absent
    pass
