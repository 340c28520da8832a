"""Granite-20B (code) — llama-arch dense, MQA (kv=1). [arXiv:2405.04324]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,  # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    lbfgs_m=4,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="granite20b-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=1, head_dim=32, d_ff=512, vocab_size=512,
        dtype="float32", attn_q_chunk=64, remat=False,
    )
