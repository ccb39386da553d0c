"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Modeling notes: interleaved MoE (every other layer routed, as in Llama-4
"interleaved MoE" / early-fusion family) + one shared expert — this is what
lands total params at ~400B with ~17B active; an all-MoE stack at these dims
would be ~780B.  40 heads / 8 KV heads don't divide tp=16 -> sequence-sharded
attention (DESIGN.md §3.2).  bf16 params + bf16 Adam moments + FSDP over dp:
400B * (2+2+2) / 512 chips ~= 4.7 GB/chip of state.
"""
from repro_torch.configs.base import ArchSpec, LMConfig, ShapeCell

CONFIG = LMConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=True,
    n_experts=128,
    top_k=1,
    moe_every=2,
    shared_expert=True,
    capacity_factor=1.25,
    attn_shard="sequence",
    rope_base=500000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fsdp=True,
    remat=True,
)

CELLS = (
    ShapeCell("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeCell("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeCell("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeCell("long_500k", "decode", seq_len=524288, global_batch=1,
              skip=True,
              skip_reason="pure full attention; no sub-quadratic structure "
                          "(DESIGN.md §5)"),
)

ARCH = ArchSpec(arch_id="llama4-maverick-400b-a17b", family="lm",
                config=CONFIG, cells=CELLS,
                notes="~400B total / ~17B active (param_count() check in tests)")
