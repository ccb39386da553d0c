"""The MIND recommender's history bag (Li et al. 2019, arXiv:1904.08030;
the item table and cells of ``repro/configs/mind.py``).

A user's click history of up to ``HIST_LEN`` items pools its item
embeddings into one vector, a weighted multi-hot bag over the 1,000,000-item
table of 64-D f32 rows (256 MB).  The serving cells pool ``BATCHES`` users
at once: 512 (``serve_p99``) and 262,144 (``serve_bulk``).  Histories are
ragged: the tail of a shorter history is id 0 with weight 0.
"""
ITEM_VOCAB = 1_000_000
EMBED_DIM = 64
HIST_LEN = 50
BATCHES = {"serve_p99": 512, "serve_bulk": 262_144}
