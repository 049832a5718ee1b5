"""Orca training of the port: the Keras and PyTorch estimators, the GAN
and inference estimators, the continuous-training loop, checkpoints,
the training guard, triggers and learning-rate schedules (counterpart of
``zoo_tpu/orca/learn``). The guard's controller and the triggers import
without ``torch``."""
