"""The port (elektronn3_tpu_torch) has a counterpart of every public name
and example of the JAX package (elektronn3_tpu), read from the sources
with ``ast`` (nothing is imported):

- every public top-level name of every JAX module (functions, classes,
  assignments) and every public method of its public classes is
  defined somewhere in the port;
- every name a JAX package's ``__init__.py`` binds (its definitions and
  ``from`` imports) is bound by the port's ``__init__.py`` of the same path;
- every ``examples/<name>.py`` of the JAX package has an
  ``examples/<name>_torch.py`` twin.

The only exceptions are the table ``EXCUSED`` below, each with its
reason: a TPU layout form (the Pallas executors' flat lane-dense
geometry, VMEM and ki-split planning, which the CUDA kernels on
channels-last tensors do not have), a flax, optax or JAX idiom, or a
counterpart under another name (``RENAMED``), whose port name must
exist.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "elektronn3_tpu"
PORT_PKG = ROOT / "elektronn3_tpu_torch"

LAYOUT = ("a TPU layout form: the Pallas executors' flat (rows, 128 "
          "lanes) geometry, VMEM or ki-split planning")
FLAX = "a flax, optax or JAX idiom with no PyTorch counterpart"

# JAX name -> port name (a defined name, or a module path with dots).
RENAMED = {
    "init_unet": "UNet",                  # the module builds its weights
    "export_stablehlo": "export_program",
    "load_stablehlo": "load_program",
    "padam": "Padam",                     # optax transformation -> optimizer
    "scale_by_padam": "Padam",
    "native": "elektronn3_tpu_torch.data.native",  # host C++ warp
    "available": "library",               # raises where it cannot build
    "planar_kernel": "conv_kernel",
    "planar_pad": "same_pads",
    "max_pool": "max_pool_cl",
    "LUConv": "_ConvBNAct",               # models/convert.py maps the trees
    "InputTransition": "_ConvBNAct",      # VNet.InputTransition_0
    "OutputTransition": "_ConvBNAct",     # VNet.OutputTransition_0
    "conv_bnact_flat": "conv_bnact",
    "conv1_bnstats_flat": "conv_bnact",   # row 3: K1's 'conv1' body
    "conv3_bnact_flat64": "conv_bnact",
    "pool_bnact_flat": "pool_bnact",
    "pool_bnact_flat_skip": "pool_bnact",
    "pool222_bnact_flat64": "pool_bnact",
    "pool222_bnact_flat64_skip": "pool_bnact",
    "pool122_bnact_flat64": "pool_bnact",
    "pool122_bnact_flat64_skip": "pool_bnact",
    "upconv_bn_flat": "upconv_bnact",
    "upconv222_bn_flat64": "upconv_bnact",
    "upconv122_bn_flat64": "upconv_bnact",
    "upconv122_from_flat64": "upconv_bnact",
    "conv_bnact_flat_vup": "conv_vup",
    "upconv122_stats_from_flat64": "upconv_stats",
    "head_bnact_from_flat": "head_bnact",
    "head_bnact_from_flat64": "head_bnact",
    "materialize_flat_acts": "materialize",
    "materialize_flat_acts64": "materialize",
    "channel_stats_dense": "channel_stats",
    "FlatActs": "FusedActs",
    "FlatActs64": "FusedActs",
    "conv_flat": "flat_conv3",
    "FlatBatchNorm": "flat_batch_norm",
    "FlatBNStats": "bn_train_prologue",
    "FlatGNStats": "gn_prologue",
}

EXCUSED = {
    **{name: f"renamed: {port}" for name, port in RENAMED.items()},
    **dict.fromkeys([
        "CC", "CC64", "JG", "JG64", "W_OFF", "W_OFF64", "VMEM_LIMIT",
        "VMEM_SLOP", "PoolCompact32", "as_dense_rows", "bwd_ki_split",
        "combine_corner_weights", "conv1x1_from_flat", "conv3_into_flat",
        "conv64_vmem_bytes", "dense_rows_ok", "flat_geometry",
        "flat_geometry64", "fold_lane_stats", "fold_lane_stats64",
        "from_flat", "from_flat64", "lane_vec64", "pack_flat_weights",
        "pack_upconv122_weights64", "pack_upconv_f64in_weights",
        "pack_upconv_weights", "pack_upconv_weights64", "pack_weights",
        "pack_weights64", "pad_width", "pad_width64", "to_flat",
        "to_flat64", "upconv122_f64in", "upconv222_f64in",
        "upconv2_transpose_to_flat", "width_mask", "width_mask64"], LAYOUT),
    # flax's dtype alias, module setup, train state and layer factories;
    # optax's optimizer state.
    **dict.fromkeys([
        "Dtype", "setup", "TrainState", "ScaleByPadamState", "conv1",
        "conv3", "upconv2", "avg_pool"], FLAX),
}


def _targets(node):
    for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
        for e in ast.walk(t):
            if isinstance(e, ast.Name):
                yield e.id


def _scan(path: Path):
    """(public top-level definitions, {public class: its public
    methods}, every name bound at the top level, ``from`` imports
    too)."""
    defs, methods, bound = set(), {}, set()
    for n in ast.parse(path.read_text()).body:
        names = []
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names = [n.name]
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            names = list(_targets(n))
        elif isinstance(n, ast.ImportFrom):
            bound |= {a.asname or a.name for a in n.names}
        defs |= {x for x in names if not x.startswith("_")}
        bound |= set(names)
        if isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            methods[n.name] = {
                m.name for m in n.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not m.name.startswith("_")}
    return defs, methods, {x for x in bound if not x.startswith("_")}


def _port_names():
    """Every name the port defines anywhere: top-level names (private
    too) and every method."""
    out = set()
    for p in PORT_PKG.rglob("*.py"):
        tree = ast.parse(p.read_text())
        for n in tree.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                out.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                out |= set(_targets(n))
            if isinstance(n, ast.ClassDef):
                out |= {m.name for m in n.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
    return out


@pytest.fixture(scope="module")
def port_names():
    return _port_names()


def _jax_modules():
    return sorted(p.relative_to(JAX_PKG) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", _jax_modules(), ids=str)
def test_every_public_name_has_a_port_counterpart(module, port_names):
    defs, methods, _ = _scan(JAX_PKG / module)
    missing = sorted(n for n in defs if n not in port_names
                     and n not in EXCUSED)
    missing += sorted(f"{cls}.{m}" for cls, ms in methods.items()
                      if cls not in EXCUSED for m in ms
                      if m not in port_names and m not in EXCUSED)
    assert not missing, f"{module}: no counterpart in the port: {missing}"


@pytest.mark.parametrize(
    "init", [p for p in _jax_modules() if p.name == "__init__.py"], ids=str)
def test_every_package_namespace_has_a_port_counterpart(init):
    port = PORT_PKG / init
    assert port.is_file(), f"the port has no {port.relative_to(ROOT)}"
    want, have = _scan(JAX_PKG / init)[2], _scan(port)[2]
    missing = sorted(want - have - set(EXCUSED))
    assert not missing, (f"{init}: names the port's package does not "
                         f"bind: {missing}")


def test_renamed_counterparts_exist(port_names):
    absent = []
    for jax_name, port in RENAMED.items():
        if "." in port:
            path = ROOT / Path(*port.split(".")).with_suffix(".py")
            ok = path.is_file()
        else:
            ok = port in port_names
        if not ok:
            absent.append(f"{jax_name} -> {port}")
    assert not absent, f"renamed counterparts missing: {absent}"


def test_every_excused_name_is_a_jax_name():
    """No stale entry: each excused name is still one of the JAX
    package's public names or methods."""
    jax_names = set()
    for module in _jax_modules():
        defs, methods, bound = _scan(JAX_PKG / module)
        jax_names |= defs | bound | {m for ms in methods.values()
                                     for m in ms}
    assert not sorted(set(EXCUSED) - jax_names)


def test_every_example_has_a_torch_twin():
    examples = ROOT / "examples"
    jax_examples = sorted(p.stem for p in examples.glob("*.py")
                          if not p.stem.endswith("_torch"))
    assert jax_examples
    missing = [f"{s}.py" for s in jax_examples
               if not (examples / f"{s}_torch.py").is_file()]
    assert not missing, f"examples without a _torch twin: {missing}"
