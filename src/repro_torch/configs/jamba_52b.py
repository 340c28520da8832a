"""Jamba-v0.1 52B — hybrid Mamba + attention (1:7), MoE 16e top-2.
[arXiv:2403.19887]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_every=2,     # MoE FFN on every other layer (Jamba e=2)
    attn_every=8,    # one attention layer per 8 (1:7 Mamba ratio)
    ssm_state=16,    # Mamba-1 state size used by Jamba
    ssm_head_dim=64,
    lbfgs_m=4,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="jamba-smoke", num_layers=8, d_model=256, num_heads=8,
        num_kv_heads=4, head_dim=32, d_ff=384, vocab_size=512,
        num_experts=4, top_k=2, ssm_state=16, ssm_head_dim=32,
        ssm_chunk=32, dtype="float32", moe_group=64, attn_q_chunk=64,
        remat=False,
    )
