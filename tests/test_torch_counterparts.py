"""The port holds the JAX package name for name, read from the source alone
(no import of either package, so no JAX is needed).

* Every module under `src/repro/` has a module at the same path under
  `src/repro_torch/`, and every public top-level name of it (a def, class or
  assignment not starting with "_", and every entry of `__all__`) is bound at
  the top level of its counterpart (a def, class, assignment or import).
* Every `examples/X.py` has `examples/X_torch.py`.
* No port module, no `*_torch.py` example and not `chip_smoke.py` imports
  `jax`, `jaxlib`, `ml_dtypes` or anything of `repro`.

What has no counterpart by nature (a JAX or TPU mechanism) stands in
EXEMPT_MODULES and EXEMPT_NAMES with the reason and the place of what does
its work in the port.  A new gap fails the test, and so does a stale
exemption: an entry whose name the reference no longer has, which the port
now has, or whose named counterpart is gone.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ROOT / "examples"
FOREIGN = ("jax", "jaxlib", "ml_dtypes", "repro")

# module (relative to src/repro) -> (why it has no counterpart, where its work is done)
EXEMPT_MODULES = {
    "compat.py": ("a shim over JAX versions (jax.sharding.AxisType, jax.set_mesh); "
                  "the port builds no JAX mesh", "launch/mesh.py:make_mesh"),
    "analysis/hlo_stats.py": ("parses XLA's HLO text, which PyTorch does not make",
                              "analysis/comm_stats.py:collective_stats"),
}

_PALLAS = "builds or runs inside the Pallas TPU kernel"
# (module, name) -> (why it has no counterpart, where its work is done)
EXEMPT_NAMES = {
    ("analysis/__init__.py", "V5E"): ("the TPU v5e's roofline constants",
                                      "analysis/roofline.py:H100"),
    ("analysis/roofline.py", "V5E"): ("the TPU v5e's roofline constants",
                                      "analysis/roofline.py:H100"),
    ("analysis/__init__.py", "parse_shape_bytes"): (
        "reads the bytes of an HLO shape string (hlo_stats)",
        "analysis/comm_stats.py:shard_bytes"),
    ("core/__init__.py", "instance_pspecs"): (
        "JAX PartitionSpecs of the instance over a mesh",
        "core/sharding.py:shard_instance"),
    ("core/sharding.py", "instance_pspecs"): (
        "JAX PartitionSpecs of the instance over a mesh",
        "core/sharding.py:shard_instance"),
    ("core/sharding.py", "num_shards"): (
        "the shard count of a JAX Mesh's axes; the port shards over the process "
        "group's world size", "core/sharding.py:shard_instance"),
    ("engines/pdhg.py", "lower_pdhg_sharded"): (
        "lowers the sharded PDHG solve to XLA for the dry run",
        "launch/dryrun.py:solver_cell"),
    ("kernels/dual_oracle.py", "dual_oracle_kernel_body"): (
        _PALLAS, "kernels/csrc/dual_oracle.cu:oracle_narrow"),
    ("kernels/dual_oracle.py", "make_dual_oracle_call"): (
        _PALLAS, "kernels/dual_oracle.py:plan_slabs"),
    ("kernels/dual_oracle.py", "fits_onehot_budget"): (
        "the VMEM budget of the one-hot MXU contraction of A x",
        "kernels/dual_oracle.py:plan_slabs"),
    ("kernels/dual_oracle.py", "pick_row_chunk"): (
        "rows per VMEM tile of the oracle", "kernels/dual_oracle.py:plan_slabs"),
    ("kernels/dual_primal.py", "dual_primal_kernel_body"): (
        _PALLAS, "kernels/csrc/dual_primal.cu:primal_narrow"),
    ("kernels/dual_primal.py", "make_dual_primal_call"): (
        _PALLAS, "kernels/dual_oracle.py:plan_slabs"),
    ("kernels/dual_primal.py", "fused_primal_tile"): (
        _PALLAS, "kernels/csrc/primal_common.cuh:primal_candidate"),
    ("kernels/ops.py", "pick_block_rows"): (
        "rows per VMEM tile", "kernels/ops.py:plan_slab_kernel"),
    ("kernels/simplex_proj.py", "simplex_kernel_body"): (
        _PALLAS, "kernels/csrc/simplex_proj.cu:simplex_narrow"),
    ("kernels/simplex_proj.py", "make_simplex_call"): (
        _PALLAS, "kernels/simplex_proj.py:plan_simplex"),
    ("kernels/simplex_proj.py", "bitonic_sort_desc"): (
        "the lane-wise bitonic network of the Pallas kernel",
        "kernels/csrc/primal_common.cuh:simplex_segment"),
    ("kernels/simplex_proj.py", "inclusive_scan"): (
        "the lane-wise Hillis-Steele scan of the Pallas kernel",
        "kernels/csrc/primal_common.cuh:simplex_segment"),
}


def _top_level(tree: ast.Module):
    """Module-level statements, through top-level if/try blocks."""
    stack = list(tree.body)
    while stack:
        node = stack.pop(0)
        if isinstance(node, (ast.If, ast.Try)):
            stack[:0] = node.body + node.orelse + getattr(node, "finalbody", []) + [
                s for h in getattr(node, "handlers", []) for s in h.body]
            continue
        yield node


def _assigned(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]


def _dunder_all(tree: ast.Module) -> list[str]:
    for node in _top_level(tree):
        if isinstance(node, ast.Assign) and "__all__" in _assigned(node):
            return [ast.literal_eval(e) for e in node.value.elts]
    return []


def public_names(path: pathlib.Path) -> set[str]:
    """A reference module's public top-level names."""
    tree = ast.parse(path.read_text())
    names = set(_dunder_all(tree))
    for node in _top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_assigned(node))
    return {n for n in names if not n.startswith("_")}


def bound_names(path: pathlib.Path) -> set[str]:
    """Every name a port module binds at its top level."""
    names = set()
    for node in _top_level(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_assigned(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def foreign_imports(path: pathlib.Path) -> list[str]:
    """Imports of JAX or of the JAX package anywhere in the file."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        bad += [f"{path.relative_to(ROOT)}:{node.lineno} {m}" for m in mods
                if m.split(".")[0] in FOREIGN]
    return bad


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_has_its_counterpart_name_for_name(rel):
    port = PORT / rel
    if rel in EXEMPT_MODULES:
        return  # held by test_exemptions_are_current
    assert port.is_file(), f"src/repro/{rel} has no counterpart src/repro_torch/{rel}"
    exempt = {name for (mod, name) in EXEMPT_NAMES if mod == rel}
    missing = sorted(public_names(REF / rel) - bound_names(port) - exempt)
    assert not missing, f"src/repro_torch/{rel} lacks {missing}"


def _counterpart_exists(where: str) -> bool:
    path, _, name = where.partition(":")
    target = PORT / path
    if not target.is_file():
        return False
    if target.suffix == ".py":
        return name in bound_names(target)
    return name in target.read_text()


def test_exemptions_are_current():
    for rel, (why, where) in EXEMPT_MODULES.items():
        assert why and (REF / rel).is_file(), f"stale module exemption {rel}"
        assert not (PORT / rel).exists(), f"{rel} now has a counterpart: drop its exemption"
        assert _counterpart_exists(where), f"{rel}: counterpart {where} not found"
    for (rel, name), (why, where) in EXEMPT_NAMES.items():
        assert why and name in public_names(REF / rel), f"stale exemption {rel}:{name}"
        assert name not in bound_names(PORT / rel), (
            f"src/repro_torch/{rel} now binds {name}: drop its exemption")
        assert _counterpart_exists(where), f"{rel}:{name}: counterpart {where} not found"


def test_every_example_has_its_port():
    refs = sorted(p.stem for p in EXAMPLES.glob("*.py") if not p.stem.endswith("_torch"))
    assert refs, "no reference examples found"
    missing = [f"examples/{s}_torch.py" for s in refs
               if not (EXAMPLES / f"{s}_torch.py").is_file()]
    assert not missing, missing


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + sorted(EXAMPLES.glob("*_torch.py")) + [
        ROOT / "chip_smoke.py"]
    bad = [b for f in files for b in foreign_imports(f)]
    assert not bad, bad
