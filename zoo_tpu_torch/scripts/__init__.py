"""Chaos smokes of the port's wire path, copies of ``scripts/check_*.py``
that run over the port's ``ReplicaGroup`` (``python -m
zoo_tpu_torch.scripts.check_llm_serving --device cpu``)."""
