"""The port's pipeline layer: one file (``runner``), a series or a directory
(``batch_runner``), one large slice sharded over ranks
(``spatial_runner``), the DB (``storage``), the run trace (``trace``,
``profiler``), the deterministic agents (``agents``), the run-scoped
chat (``chat``) and deploy-time priming (``prime``: ``python -m
mdx_torch.pipeline.prime`` builds the two native libraries and warms each
entry point).

Counterpart of ``mdx.pipeline`` without the JAX compile cache
(``compile_cache``: the port compiles no per-program executable);
``python -m mdx_torch`` is its CLI.
"""
