"""Phi-4-mini 3.8B — dense, RoPE + SwiGLU + GQA. [arXiv:2412.08905]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="arXiv:2412.08905",
    num_layers=32,
    d_model=3072,
    num_heads=24,   # 24 % 16 != 0 -> heads replicate on the 16-way model
    num_kv_heads=8, # axis; mlp/vocab still shard (see utils/sharding.py)
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="phi4-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=512,
        dtype="float32", attn_q_chunk=64, remat=False,
    )
