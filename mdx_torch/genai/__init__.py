"""The port's slice of the GenAI layer: only the chat-completions client.

:mod:`mdx_torch.genai.client` is the port's copy of ``mdx/genai/client.py``
(stdlib HTTP, an injectable transport), which the run-scoped chat
(:mod:`mdx_torch.pipeline.chat`) calls.  The JAX package's planner,
agents, tools and orchestrator (``mdx/genai``: an LLM loop that calls a
remote model) stay out of the port by design; a ``genai=True`` run falls
back to the deterministic path, as JAX's does when its model call fails
(:func:`mdx_torch.pipeline.runner.run_pipeline`).
"""
