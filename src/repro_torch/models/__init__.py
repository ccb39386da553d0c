"""Model code (port of ``repro/models/``): ``layers``, ``recsys``,
``attention``, ``moe`` and the ``transformer`` (dense, MoE and
interleaved)."""
