"""The port stands alone: importing ``flexflow_tpu_torch`` loads neither
JAX nor anything of the JAX package, and no source of the port (nor
chip_smoke.py) imports them."""
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flexflow_tpu)(\.|\s|$)", re.MULTILINE
)


def test_import_leaves_jax_and_the_jax_package_unloaded():
    code = (
        "import sys\n"
        "import flexflow_tpu_torch\n"
        "from flexflow_tpu_torch.serve import kernels, _cuda, llm, engine, request_manager\n"
        "from flexflow_tpu_torch.models import llama, hf_utils\n"
        "import flexflow_tpu_torch.__main__\n"
        "from flexflow_tpu_torch.ops import flash_attention\n"
        "from flexflow_tpu_torch import optimizers\n"
        "from flexflow_tpu_torch.core import remat\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flexflow_tpu' or m.startswith('flexflow_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


def _sources():
    pkg = REPO / "flexflow_tpu_torch"
    files = sorted(p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts)
    return files + [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_scan_catches_forbidden_imports():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from flexflow_tpu.serve import kernels")
    assert FORBIDDEN.search("from flexflow_tpu import models")
    assert not FORBIDDEN.search("from flexflow_tpu_torch.serve import kernels")
    assert not FORBIDDEN.search("# the JAX package: import jax")


def test_chip_smoke_ok_line_counts_the_one_card_it_drives():
    """chip_smoke.py drives cuda:0 alone: it exposes only that card before
    CUDA starts, so the ok line's torch.cuda.device_count() is 1 on a
    machine that shows several cards. An empty value hides every card,
    and stays so: the run then fails for want of a CUDA device."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.one_card(None) == "0"
    assert chip_smoke.one_card("") == ""
    assert chip_smoke.one_card(" ") == " "
    assert chip_smoke.one_card("0,1,2,3") == "0"
    assert chip_smoke.one_card("3, 1") == "3"
    assert chip_smoke.one_card("GPU-5f2e") == "GPU-5f2e"
