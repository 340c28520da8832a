"""The yardstick's arithmetic: the H100's published peaks, the least time
of a kernel call from its bytes and operations, the Gram kernel's byte
count, and the model FLOPs of a transformer train step.

Frozen here so that a change to the program cannot move the bar it is
measured against.  Peaks: NVIDIA H100 SXM data sheet, dense rates at the
700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12      # f32 outside the tensor cores (TF32 is off)
BF16_FLOPS_PER_S = 989e12    # dense bf16, tensor cores


def bound_s(n_bytes: float, n_flops: float,
            flops_per_s: float = F32_FLOPS_PER_S) -> float:
    """The least seconds a call can take: the larger of its bytes over the
    HBM bandwidth and its operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s)


# --- bytes and operations of one launch of each hand-written kernel -------
def gram_cost(m: int, D: int, history_elt: int = 4) -> tuple[float, float]:
    """The (2m+1)^2 Gram of [s_0.., y_0.., g] read in place: 2m history rows
    of ``history_elt`` bytes and one f32 g row per column, the f32 matrix
    written once; the symmetric half's multiply-adds."""
    n = 2 * m + 1
    return (D * (2.0 * m * history_elt + 4) + n * n * 4.0,
            2.0 * D * n * (n + 1) / 2)


# --- model FLOPs ------------------------------------------------------------
def dense_matmul_params(cfg: dict) -> float:
    """Parameters that take part in a matmul a token: every layer's
    attention and SwiGLU projections and the LM head (the embedding is a
    gather)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = d * h * hd * 2 + d * kv * hd * 2
    mlp = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + mlp) + d * cfg["vocab_size"]


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N a token for the matmul
    parameters, plus causal attention's QK^T and PV (2 S^2 H hd a sequence
    and layer forward, half of the square by the mask, x3 with the
    backward)."""
    tokens = batch * seq
    h, hd = cfg["num_attention_heads"], cfg["head_dim"]
    attn = 3.0 * 2.0 * seq * seq * h * hd * batch * cfg["num_hidden_layers"]
    return 6.0 * dense_matmul_params(cfg) * tokens + attn
