"""Serving: the paged continuous-batching engine (engine.py) over the
block pool (paging.py), its dense-mode steps (steps.py) and the CLI
(serve.py)."""
