"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

vocab 49155 is not divisible by tp=16 -> padded to 49280 (Megatron-style
vocab padding; logits masked in the loss).
"""
from repro_torch.configs.base import ArchSpec, LMConfig, ShapeCell

CONFIG = LMConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=True,
    n_experts=32,
    top_k=8,
    moe_every=1,
    capacity_factor=1.25,
    attn_shard="heads",
    tie_embeddings=True,
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

ARCH = ArchSpec(arch_id="granite-moe-1b-a400m", family="lm", config=CONFIG,
                cells=CELLS)
