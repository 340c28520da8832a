"""Qwen3-MoE 235B-A22B — 128 experts top-8, fine-grained.
[hf:Qwen/Qwen3-30B-A3B family card]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,        # per-expert ffn (fine-grained)
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
    lbfgs_m=2,  # 235B: 2 pairs bf16 = 7.3GB/chip ZeRO-sharded
    fsdp=True,
    grad_accum_dtype="bfloat16",
    train_n_micro=8,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="qwen3moe-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512,
        num_experts=4, top_k=2, dtype="float32", moe_group=64,
        attn_q_chunk=64, remat=False,
    )
