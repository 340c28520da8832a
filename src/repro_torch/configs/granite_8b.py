"""Granite-8B (code) — llama-arch dense, GQA kv=8. [arXiv:2405.04324]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-8b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="granite8b-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=512,
        dtype="float32", attn_q_chunk=64, remat=False,
    )
