"""The port's datasets; ``load_vertical`` is exported here, as the JAX
package's ``data/__init__.py`` exports it (the rest by module)."""

from fedml_tpu_torch.data.vertical_tabular import load_vertical

__all__ = ["load_vertical"]
