"""DBRX-132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    top_k=4,
    lbfgs_m=4,  # 132B params: history kept short + bf16 to fit HBM
    fsdp=True,
    grad_accum_dtype="bfloat16",
    train_n_micro=8,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="dbrx-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=4, head_dim=32, d_ff=384, vocab_size=512,
        num_experts=4, top_k=2, dtype="float32", moe_group=64,
        attn_q_chunk=64, ssm_chunk=32, remat=False,
    )
