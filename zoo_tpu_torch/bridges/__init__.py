"""Bridges from other frameworks' models into the port's Keras engine
(counterpart of ``zoo_tpu/bridges``). :mod:`.fx_bridge` traces a torch
``nn.Module`` with ``torch.export``; the TensorFlow and Keras bridges
wait for ROADMAP A.16."""
