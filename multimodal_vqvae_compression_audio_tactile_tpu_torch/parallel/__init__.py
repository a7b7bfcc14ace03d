"""Data parallelism on ``torch.distributed`` (``mesh.py``) and its
multi-process dry run (``dryrun.py``)."""
