"""HuBERT-XLarge — encoder-only audio transformer (w2v2 arch).
[arXiv:2106.07447]  Frontend (conv feature extractor) is a stub: the model
consumes precomputed frame embeddings; see DESIGN.md carve-outs."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,  # full MHA
    head_dim=80,
    d_ff=5120,
    vocab_size=504,   # masked-unit prediction targets
    is_encoder=True,
    frontend="audio_embed",
))


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        name="hubert-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=8, head_dim=32, d_ff=512, vocab_size=64,
        dtype="float32", attn_q_chunk=64, remat=False,
    )
