"""The PyTorch port imports no JAX, flax, optax or ``shm_tpu`` module.

The scan is static (AST), because the test process may have JAX imported
already: a runtime check of ``sys.modules`` could not tell who imported it.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "shm_tpu")
PORT_FILES = sorted((ROOT / "shm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN            # "shm_tpu_torch" is a different top name


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("chip_smoke.py", "shm_tpu_torch/ops/fused_vae.py",
                 "shm_tpu_torch/ops/fused_mingru.py",
                 "shm_tpu_torch/ops/fused_attention.py",
                 "shm_tpu_torch/ops/_gate.py",
                 "shm_tpu_torch/models/minrnn.py",
                 "shm_tpu_torch/models/attention.py",
                 "shm_tpu_torch/serve.py", "shm_tpu_torch/pipeline.py",
                 "shm_tpu_torch/ops/lstm_train.py",
                 "shm_tpu_torch/train/__init__.py", "shm_tpu_torch/train/vae.py",
                 "shm_tpu_torch/train/checkpoint.py",
                 "shm_tpu_torch/cli/stage4dof.py",
                 "shm_tpu_torch/cli/stage1dof.py",
                 "shm_tpu_torch/sim/signals.py",
                 "shm_tpu_torch/data/splits.py",
                 "shm_tpu_torch/sim/__init__.py", "shm_tpu_torch/sim/prng.py",
                 "shm_tpu_torch/sim/forces.py", "shm_tpu_torch/sim/newmark.py",
                 "shm_tpu_torch/sim/faults.py",
                 "shm_tpu_torch/tools/workload.py",
                 "shm_tpu_torch/tools/probe_f32_cliff.py",
                 "shm_tpu_torch/tools/probe_vpu_bound.py",
                 "shm_tpu_torch/tools/probe_mingru_recur.py",
                 "shm_tpu_torch/serve_openlab.py",
                 "shm_tpu_torch/cli/openlab.py",
                 "shm_tpu_torch/data/features.py",
                 "shm_tpu_torch/models/forest.py",
                 "shm_tpu_torch/models/svm.py",
                 "shm_tpu_torch/models/ml.py"):
        assert must in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_package_import(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    bad = sorted({m for m in _imported_modules(tree) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_a_card_or_compiler():
    """Importing a module builds no kernel and needs no CUDA runtime."""
    import importlib

    for path in PORT_FILES:
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)
        if name != "chip_smoke":
            importlib.import_module(name)


KERNEL_ENTRIES = {
    "fused_vae.cu": ["shm_fused_vae_gate_f32", "shm_fused_vae_probe",
                     "shm_fused_vae_info"],
    "lstm_train.cu": ["shm_lstm2_enc_fwd_f32", "shm_lstm2_enc_bwd_f32",
                      "shm_lstm2_dec_fwd_f32", "shm_lstm2_dec_bwd_f32",
                      "shm_lstm2_fwd_scan_info", "shm_lstm2_bwd_scan_info"],
    "fused_mingru.cu": ["shm_fused_mingru_gate_f32", "shm_fused_mingru_variant",
                        "shm_fused_mingru_info"],
    "fused_attention.cu": ["shm_fused_attention_gate_f32"],
    "probe_matmul_loop.cu": ["shm_probe_matmul_loop",
                             "shm_probe_matmul_loop_blocks"],
    "probe_mingru_gate.cu": ["shm_probe_mingru_gate", "shm_probe_mingru_gate_info"],
}
# the module that wraps each source: ops/<source>.py, or the probe's own
WRAPPERS = {
    "probe_matmul_loop.cu": "tools/probe_f32_cliff.py",
    "probe_mingru_gate.cu": "tools/probe_mingru_recur.py",
}


def test_kernel_sources_sit_beside_their_wrappers():
    csrc = ROOT / "shm_tpu_torch" / "ops" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == set(KERNEL_ENTRIES)
    for name in KERNEL_ENTRIES:
        wrapper = ROOT / "shm_tpu_torch" / WRAPPERS.get(
            name, "ops/" + name.replace(".cu", ".py"))
        assert wrapper.is_file()
        assert f'load_library("{name[:-3]}")' in wrapper.read_text()


@pytest.mark.parametrize("source", list(KERNEL_ENTRIES))
def test_kernel_source_is_hand_written_cuda_with_a_c_entry(source):
    src = (ROOT / "shm_tpu_torch" / "ops" / "csrc" / source).read_text()
    for entry in KERNEL_ENTRIES[source]:
        assert f'extern "C" int {entry}(' in src
    assert "__global__" in src and "<<<" in src
    assert "atomicAdd" not in src and "use_fast_math" not in src.replace(
        "no --use_fast_math", "")
    # every product is the kernel's own code: no library header stands in
    includes = [l.split()[1] for l in src.splitlines() if l.startswith("#include")]
    assert includes == ["<cuda_runtime.h>"]


@pytest.mark.parametrize("module, bad", [
    ("jax", True), ("jax.numpy", True), ("flax.linen", True), ("optax", True),
    ("shm_tpu", True), ("shm_tpu.utils.io", True), ("shm_tpu_torch", False),
    ("shm_tpu_torch.ops", False), ("torch", False), ("numpy", False),
])
def test_forbidden_rule(module, bad):
    assert _forbidden(module) is bad


def test_scan_sees_every_import_form():
    src = ("import jax\nfrom flax import linen\nimport shm_tpu.serve as s\n"
           "from shm_tpu_torch import ops\n__import__('optax')\n"
           "import importlib\nimportlib.import_module('shm_tpu.config')\n")
    found = sorted(m for m in _imported_modules(ast.parse(src)) if _forbidden(m))
    assert found == ["flax", "jax", "optax", "shm_tpu.config", "shm_tpu.serve"]
