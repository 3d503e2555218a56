"""The PyTorch port, chip_smoke.py and the port's scripts import neither JAX
(nor flax, optax, orbax) nor the JAX package: an AST scan of every import
statement."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "torch_semantic_segmentation_tpu_torch"
BANNED = ("jax", "flax", "optax", "orbax", "torch_semantic_segmentation_tpu")
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py")))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _banned(module: str) -> bool:
    return any(module == b or module.startswith(b + ".") for b in BANNED)


def test_scan_covers_the_package():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    assert {"ops/sepconv.py", "serving.py", "models/fastscnn.py",
            "compat/torch_loader.py", "ops/resize_ce.py", "ops/mbconv.py",
            "ops/folded_bn.py", "losses/__init__.py", "train.py",
            "ops/depthwise.py", "data/transforms.py", "metrics/__init__.py",
            "eval.py", "ops/upsample_concat.py", "ops/pool.py",
            "models/unet.py", "models/resnet.py", "models/deeplab.py",
            "ops/blocks.py", "models/enet.py", "models/bisenet.py",
            "models/icnet.py", "data/class_weights.py", "models/erfnet.py",
            "models/esnet.py", "models/lednet.py",
            "models/contextnet.py"} <= names


def test_banned_rule():
    assert _banned("jax.numpy") and _banned("torch_semantic_segmentation_tpu")
    assert _banned("torch_semantic_segmentation_tpu.ops.upsample")
    assert not _banned("torch_semantic_segmentation_tpu_torch.ops")
    assert not _banned("jaxtyping") and not _banned("torch")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
