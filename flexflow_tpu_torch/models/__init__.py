from . import hf_utils, llama

# Model-family registry (flexflow_tpu/models/__init__.py FAMILIES); the
# other families come with later slices of the port.
FAMILIES = {
    "llama": llama,
}

__all__ = ["llama", "hf_utils", "FAMILIES"]
