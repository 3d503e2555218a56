"""The PyTorch port (its CLIs too), chip_smoke.py and the port's scripts
import neither JAX (nor flax, optax, orbax) nor the JAX package: an AST
scan of every import statement. The port and chip_smoke.py import neither
cv2 nor PIL either: the card's machine has neither (the port decodes by its
native loader)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "torch_semantic_segmentation_tpu_torch"
BANNED = ("jax", "flax", "optax", "orbax", "torch_semantic_segmentation_tpu")
CODECS = ("cv2", "PIL")
# the port's scripts: the torch_* ones, and the one that imports
# chip_smoke.py and the port under another name
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py"))
         + [ROOT / "scripts" / "spatial_halo_plan.py"])
ON_THE_CARD = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _banned(module: str, banned=BANNED) -> bool:
    return any(module == b or module.startswith(b + ".") for b in banned)


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
            "models/contextnet.py", "data/synthetic.py", "data/cityscapes.py",
            "data/camvid.py", "data/bdd.py", "data/mapillary.py",
            "data/native_loader.py", "data/pipeline.py", "checkpoint.py",
            "compat/key_maps.py", "models/__init__.py", "cli/__init__.py",
            "cli/common.py", "cli/train.py", "cli/eval.py",
            "cli/predict.py", "parallel/__init__.py",
            "parallel/distributed.py", "parallel/mesh.py", "profiling.py",
            "debug.py"} <= names
    assert ROOT / "scripts" / "spatial_halo_plan.py" in FILES


def test_banned_rule():
    assert _banned("jax.numpy") and _banned("torch_semantic_segmentation_tpu")
    assert _banned("torch_semantic_segmentation_tpu.ops.upsample")
    assert not _banned("torch_semantic_segmentation_tpu_torch.ops")
    assert not _banned("jaxtyping") and not _banned("torch")
    assert _banned("cv2", CODECS) and _banned("PIL.Image", CODECS)
    assert not _banned("PILlow", CODECS)


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", ON_THE_CARD,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_codec_imports(path):
    bad = [m for m in _imported_modules(path) if _banned(m, CODECS)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
