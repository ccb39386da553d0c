"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global attention, 128k+ context. [hf:google/gemma-3-1b-pt; unverified]

head_dim=256 (gemma convention; the q/k/v projections are rectangular).
Every 6th layer is global, the rest use a 1024-token sliding window — which
makes long_500k decode tractable (5/6 of layers touch a bounded window):
this is the ONE assigned LM arch that runs the long_500k cell.
"""
from repro_torch.configs.base import ArchSpec, LMConfig, ShapeCell

CONFIG = LMConfig(
    name="gemma3-4b",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,
    attn_shard="sequence",
    rope_base=1000000.0,
    logit_softcap=0.0,
    tie_embeddings=True,
)

CELLS = (
    ShapeCell("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeCell("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeCell("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeCell("long_500k", "decode", seq_len=524288, global_batch=1),
)

ARCH = ArchSpec(arch_id="gemma3-4b", family="lm", config=CONFIG, cells=CELLS)
