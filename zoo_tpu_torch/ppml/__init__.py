"""Privacy-preserving building blocks of the port (counterpart of
``zoo_tpu/ppml``): AES model and file encryption at rest
(:class:`EncryptSupportive`), used by
``InferenceModel.load_encrypted`` and ``save_encrypted``."""

from zoo_tpu_torch.ppml.crypto import EncryptSupportive

__all__ = ["EncryptSupportive"]
