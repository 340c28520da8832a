"""Chameleon-34B — early-fusion VLM; images arrive as VQ tokens inside the
text vocabulary, so the backbone input is token ids. [arXiv:2405.09818]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,    # chameleon uses qk-norm for training stability
    lbfgs_m=4,
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="chameleon-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=512,
        dtype="float32", attn_q_chunk=64, remat=False,
    )
