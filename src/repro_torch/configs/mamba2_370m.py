"""Mamba2-370M — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,           # mamba blocks only, no separate FFN
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="mamba2-smoke", num_layers=2, d_model=256, vocab_size=512,
        ssm_state=32, ssm_head_dim=32, ssm_chunk=32, dtype="float32",
        remat=False,
    )
