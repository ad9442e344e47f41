"""The port's serving layer: the JSON API, its run executor, the legacy
server-rendered UI and their configuration, copies of ``mdx/serve``.

The same HTTP surface as the JAX package's server — the reference's 12
JSON routes (:mod:`mdx_torch.serve.api`) and the legacy pages
(:mod:`mdx_torch.serve.legacy`) on the from-scratch WSGI router
(:mod:`mdx_torch.serve.wsgi`) — with runs on the card: a bounded pool of
worker threads (:mod:`mdx_torch.serve.executor`) calls
:func:`mdx_torch.pipeline.runner.run_pipeline` with each job's device.

    PORT=5000 python -m mdx_torch.serve.api       # the JSON API
    PORT=8000 python -m mdx_torch.serve.legacy    # the legacy UI
"""

__all__ = ["create_app"]


def __getattr__(name: str):
    # imported on use, so that ``python -m mdx_torch.serve.api`` runs the
    # module once (an import here would load it before runpy executes it)
    if name == "create_app":
        from mdx_torch.serve.api import create_app

        return create_app
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
