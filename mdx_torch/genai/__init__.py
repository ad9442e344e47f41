"""GenAI mode: the LLM planner, tuning loop and explainability.

The port's copy of ``mdx/genai``:

* :mod:`mdx_torch.genai.client` — the chat-completions client (stdlib
  HTTP, an injectable transport: ``set_transport``), which the agents and
  the run-scoped chat (:mod:`mdx_torch.pipeline.chat`) call;
* :mod:`mdx_torch.genai.tools` — the thread-local image store and the four
  function tools, on the run's device;
* :mod:`mdx_torch.genai.agents` — the prompts and the agent loop with its
  model fallback;
* :mod:`mdx_torch.genai.orchestrator` — the 5-phase pipeline, its
  degradation chain and the LLM cost guard.

``run_pipeline(genai=True)`` (:mod:`mdx_torch.pipeline.runner`) drives it.
Without ``OPENAI_API_KEY`` and without an installed transport the planner's
model call fails and the run falls back to the deterministic path, as in
the JAX package.
"""
