"""The port's pipeline layer: one file (``runner``), a series or a directory
(``batch_runner``), one large slice sharded over ranks
(``spatial_runner``), the DB (``storage``), the run trace (``trace``,
``profiler``), the deterministic agents (``agents``) and the run-scoped
chat (``chat``).

Counterpart of ``mdx.pipeline`` without the JAX compile cache and its
warm-up (``compile_cache``, ``prime``); ``python -m mdx_torch`` is its CLI.
"""
