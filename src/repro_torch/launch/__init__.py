"""Entry points: the paged continuous-batching serving engine (engine.py)
over the block pool (paging.py) and its CLI (serve.py); LM training
(train.py) and LLM-scale DENSE (dense_llm_oneshot.py); the steps they
share (steps.py); the device meshes over the process world (mesh.py)
and the partitioning rules (shardings.py)."""
