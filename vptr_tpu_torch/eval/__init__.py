"""Part of the vptr_tpu_torch port (see the package docstring)."""
