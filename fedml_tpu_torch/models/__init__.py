"""The port's models; the GAN pair is exported here, as the JAX package's
``models/__init__.py`` exports it (the rest by module)."""

from fedml_tpu_torch.models.gan import Discriminator, Generator

__all__ = ["Discriminator", "Generator"]
