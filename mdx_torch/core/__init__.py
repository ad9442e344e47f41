"""Numeric core: batched metrics, enhancement, validation, score, QA steps.

Counterpart of ``mdx.core`` on PyTorch tensors, one module each:
``metrics``, ``enhance``, ``validate``, ``score``, ``qa``.
"""
