"""Qwen3-32B — dense, GQA + qk_norm. [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-32b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    lbfgs_m=4,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="qwen3-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=512,
        dtype="float32", attn_q_chunk=64, remat=False,
    )
