"""The port's pipeline layer: one file (``runner``), a series or a directory
(``batch_runner``), one large slice sharded over ranks
(``spatial_runner``), the DB (``storage``), the run trace (``trace``,
``profiler``) and the deterministic agents (``agents``).

Counterpart of ``mdx.pipeline`` without the GenAI chat and the JAX compile
cache; ``python -m mdx_torch`` is its CLI.
"""
