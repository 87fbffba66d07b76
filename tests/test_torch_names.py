"""Public names: every module of ``repro_torch`` offers the names of its
counterpart in ``repro``, save the exceptions listed below with a reason.

A module's public names are its attributes without a leading underscore,
less module objects and ``typing`` objects.  Module objects are left out
because which submodules a package holds as attributes depends on what the
process has imported so far, and a library alias (``jax``, ``jnp``, ``np``,
``functools``, ``torch``) is each package's own tool, not its API.  The
submodules are compared as files instead: each module of a ported
subpackage has its port, save the listed ones.  Each listed exception must
still be missing, so the lists shrink as the slices that add the names
land.  The entry points in ``SIGNATURES`` take the reference's parameters
in its order, save the listed differences.
"""
import importlib
import importlib.util
import inspect
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_TRACERS = ("no tracers in PyTorch: the port runs eagerly, so nothing is "
            "ever traced (see the port's multiquery.py docstring)")
_SLICE_7 = ("the LM scaffold (slice 7: its token pipeline, parameter, "
            "batch and cache specs): not ported yet")
_PALLAS = ("the TPU's Pallas kernel; the port's kernel is CUDA C++ under "
           "kernels/csrc, launched by the same-named wrapper")
_SNOWFLAKE_IMPORT = ("the reference's multiquery imports it from "
                     "core.query.snowflake for its own use; both packages "
                     "define it there")
_JAX_SHARDING = ("jax's sharding machinery (``NamedSharding``, "
                 "``shard_map``): the port places tensors on a Mesh's "
                 "torch.devices itself (core/query/sharding.py's Placed) "
                 "and loops over the shards")
_MESH_IMPORT = ("the reference's sharding imports it from launch.mesh for "
                "its shard_map specs; the port reads the mesh through "
                "launch.mesh.device_grid")
_LM_SHARDING = ("jax's PartitionSpec, for with_sharding_constraint: the LM "
                "is not sharded in the port yet, so constrain is the "
                "identity")
_INTERPRET = ("Pallas interpret mode: a port kernel wrapper given CPU "
              "tensors runs the kernel's plain version instead")
_DEVICE = ("the port's entry points run on the card unless given "
           "device='cpu'; the reference follows jax's default device")

#: module (relative to the package) → {missing name: why}
EXCEPTIONS = {
    "core.query.compile": {"holds_tracers": _TRACERS},
    "core.query.multiquery": {"holds_tracers": _TRACERS,
                              "participating_tables": _SNOWFLAKE_IMPORT,
                              "refresh_chain": _SNOWFLAKE_IMPORT},
    "core.query.serving": {"holds_tracers": _TRACERS},
    "core.query.sharding": {"NamedSharding": _JAX_SHARDING,
                            "shard_map": _JAX_SHARDING,
                            "dp_axes": _MESH_IMPORT},
    "data": {n: _SLICE_7 for n in ("TokenPipeline", "TokenPipelineConfig",
                                   "make_global_batch")},
    "kernels.fused_star_gather.ops": {"fused_star_gather_pallas": _PALLAS},
    "kernels.onehot_matmul.ops": {"onehot_matmul_pallas": _PALLAS},
    "kernels.tree_predict.ops": {"tree_predict_pallas": _PALLAS},
    "models.act_sharding": {"P": _LM_SHARDING},
    "launch.sharding": {
        "NamedSharding": _JAX_SHARDING,
        **{n: _SLICE_7 for n in ("FSDP", "batch_pspec", "cache_pspec",
                                 "dp_axes", "param_pspec",
                                 "param_shardings")}},
}

#: Subpackages whose every module is ported, and the module files of the
#: reference that have no port file, with why.
PORTED_SUBPACKAGES = ("core/fusion", "core/laq", "core/query", "kernels",
                      "configs", "models")
MISSING_FILES = {
    "kernels/fused_star_gather/kernel.py": _PALLAS,
    "kernels/onehot_matmul/kernel.py": _PALLAS,
    "kernels/tree_predict/kernel.py": _PALLAS,
}

#: Entry points whose parameters differ from the reference's:
#: (module, qualified name) → {parameter: why}, for parameters on one side
#: only.  Parameters both sides have come in the same order.
SIGNATURES = {
    ("launch.serve", "FusedFeatureServer.__init__"): {
        "interpret": _INTERPRET, "device": _DEVICE},
    ("launch.serve", "run_serving"): {"device": _DEVICE},
    ("launch.serve", "decode_batch"): None,     # the port's own
    ("models.lm", "LM.init"): {"rng": "a torch.Generator replaces the jax "
                                      "PRNG key (named generator)",
                               "generator": "see rng",
                               "device": _DEVICE},
    ("models.lm", "LM.forward"): {},
    ("models.lm", "LM.decode_step"): {},
    ("models.lm", "LM.init_decode_state"): {},
    ("models.attention", "naive_attention"): {},
    ("models.attention", "flash_attention"): {},
    ("models.attention", "attention_decode"): {},
}


def _port_modules():
    """Every module of the port that has a counterpart in the reference,
    relative to the package ("" for the package itself)."""
    out = []
    for p in sorted(PORT.rglob("*.py")):
        parts = list(p.relative_to(PORT).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        rel = ".".join(parts)
        if importlib.util.find_spec(_join("repro", rel)) is not None:
            out.append(rel)
    return out


def _public(module) -> set:
    names = set()
    for n in dir(module):
        if n.startswith("_"):
            continue
        obj = getattr(module, n)
        if isinstance(obj, types.ModuleType):
            continue
        if getattr(obj, "__module__", None) == "typing":
            continue
        names.add(n)
    return names


def _join(package: str, rel: str) -> str:
    return package + ("." + rel if rel else "")


def test_every_port_module_is_checked():
    mods = _port_modules()
    for rel in ("core.laq", "core.laq.sort", "core.query",
                "core.query.streaming", "core.query.compile",
                "core.query.sharding", "launch.mesh", "launch.sharding",
                "launch", "launch.serve", "models", "models.lm",
                "models.attention", "configs", "configs.registry",
                "configs.smollm_360m"):
        assert rel in mods
    assert set(EXCEPTIONS) <= set(mods)


@pytest.mark.parametrize("rel", _port_modules(), ids=lambda r: r or "repro")
def test_port_module_has_reference_names(rel):
    ref = _public(importlib.import_module(_join("repro", rel)))
    port = _public(importlib.import_module(_join("repro_torch", rel)))
    allowed = EXCEPTIONS.get(rel, {})
    missing = sorted(ref - port - set(allowed))
    assert not missing, f"repro_torch.{rel} lacks {missing}"
    stale = sorted(set(allowed) - (ref - port))
    assert not stale, (f"repro_torch.{rel} has {stale} now: remove them "
                       "from EXCEPTIONS")
    for name, why in allowed.items():
        assert why, name


def test_ported_subpackages_have_every_module():
    ref_root = ROOT / "src" / "repro"
    missing = set()
    for sub in PORTED_SUBPACKAGES:
        for p in (ref_root / sub).rglob("*.py"):
            rel = p.relative_to(ref_root).as_posix()
            if not (PORT / rel).exists():
                missing.add(rel)
    assert missing == set(MISSING_FILES), sorted(missing)
    assert all(MISSING_FILES.values())


def test_c1_names_behave_as_the_reference():
    """The names ROADMAP's C1 found missing do what the reference's do (or,
    where the reference's contract allows two answers, give the one the
    port's eager execution implies)."""
    import numpy as np

    import repro.core.query as RQ
    import repro_torch.core.query as TQ
    from repro.core.fusion import prefuse as ref_prefuse
    from repro_torch.core.fusion import prefuse
    from repro_torch.core.laq import changed_spans
    from torch_parity import (port_query, stream_model, stream_query,
                              stream_star)

    assert TQ.DENSE_JOIN_ELEMS == RQ.DENSE_JOIN_ELEMS
    assert TQ.MXU_SEGMENT_ADVANTAGE == RQ.MXU_SEGMENT_ADVANTAGE
    assert TQ.changed_spans is changed_spans
    both = stream_star(0)
    rq = stream_query(stream_model())
    q = port_query(rq)
    plan = TQ.compile_query(both.port, q)
    ref_plan = RQ.compile_query(both.ref, rq)
    assert plan.is_traced is False and ref_plan.is_traced is False
    assert (prefuse(plan.star, q.model).nbytes()
            == ref_prefuse(ref_plan.star, rq.model).nbytes())
    fact = both.port["fact"]
    t = fact.with_matrix(fact.matrix[:, :2], ["fk1", "fk2"])
    assert t.columns == ("fk1", "fk2") and t.keys is fact.keys
    assert fact.with_matrix(fact.matrix).columns == fact.columns
    rt = TQ.compile_serving(both.port, q, buckets=(8,))
    rt.serve({"fk1": np.zeros(3, np.int32), "fk2": np.zeros(3, np.int32)})
    assert rt.jit_cache_size() is None


def _params(package, rel, qualname):
    obj = importlib.import_module(_join(package, rel))
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return list(inspect.signature(obj).parameters)


@pytest.mark.parametrize("key", SIGNATURES, ids=lambda k: f"{k[0]}:{k[1]}")
def test_entry_point_signatures(key):
    """The port's entry points take the reference's parameters, in its
    order, save the listed differences (each still a difference)."""
    rel, qualname = key
    port = _params("repro_torch", rel, qualname)
    allowed = SIGNATURES[key]
    if allowed is None:          # no counterpart in the reference
        assert not hasattr(importlib.import_module(_join("repro", rel)),
                           qualname.split(".")[0])
        return
    ref = _params("repro", rel, qualname)
    only = set(ref) ^ set(port)
    assert only == set(allowed), (f"{rel}.{qualname}: parameters on one "
                                  f"side only {sorted(only)}")
    assert all(allowed.values())
    assert [p for p in port if p in ref] == [p for p in ref if p in port]
