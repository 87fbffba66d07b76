"""The reference's randomized workload fuzzer on the port, flat arms only.

Each case is ``repro.core.query.workload.generate_case(seed)`` for a seed
from the fixed list below (no hypothesis, no random draw): every generated
column, weight and threshold is a small integer, so each float32 sum the
engine takes is exact and the results must equal the reference's float64
numpy oracle **bit for bit** (``workload.np_oracle`` through
``workload._compare``).  The cases are carried to the port with
``tests/torch_parity.py``'s ``port_tables``/``port_query``.  Per seed:

* ``compile_query(...).run()`` under fused/nonfused × gather/matmul ×
  segment/matmul × torch/kernel against ``np_oracle``;
* ``compile_serving(...).serve`` on every fact row, fused and nonfused
  under both serve backends, against ``np_serving_oracle``;
* the append→refresh leg of ``workload.check_case``: rows appended to a
  random participating table (``workload._append_rows``, on the
  reference's catalog, then the same rows on the port's), the port's
  ``CompiledQuery.refresh()`` and a cold compile both against the oracle
  of the appended tables.  The reference refreshes through a ``Session``;
  the port's leg calls ``refresh()`` itself;
* the rewrite on/off leg: the port's ``rewrite_query`` equals the
  reference's (trail, and the rewritten IR by content), and the
  ``rewrite="off"`` plans, fused and nonfused, equal the oracle (the plans
  above run the default ``rewrite="on"``);
* the streaming leg of ``workload.check_case``: the fact axis streamed in
  16-row chunks (``stream_chunk_rows=16``), under both serve backends,
  against the oracle.

``SEEDS`` holds the flat-arm seeds (arms without ``links``) among 0–499;
the chained ones run in ``test_torch_fuzz_chain.py`` and
``test_torch_fuzz_chain_b.py``.  On the CPU the "kernel" serve backend runs each kernel's plain
version, so this file checks the port's algebra, not the CUDA code.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.laq import Catalog as RefCatalog
from repro.core.query.workload import (_append_rows, _compare,
                                       generate_case, np_oracle,
                                       np_serving_oracle)
from repro_torch.core.laq import Catalog
from repro_torch.core.query import (compile_query, compile_serving,
                                    requests_from_rows)
from torch_parity import port_query, port_tables, rewrite_leg, to_np

SEEDS = (
    2, 9, 12, 14, 15, 18, 20, 21, 23, 24, 26, 27, 31, 32, 33, 34, 35, 36,
    38, 39, 40, 42, 43, 44, 46, 47, 48, 51, 60, 64, 66, 70, 75, 78, 80,
    86, 89, 90, 98, 100, 102, 104, 108, 109, 111, 113, 114, 120, 122, 129,
    130, 132, 136, 137, 138, 139, 141, 143, 146, 148, 150, 151, 152, 156,
    157, 158, 160, 166, 168, 171, 172, 175, 177, 179, 181, 184, 186, 190,
    191, 192, 194, 195, 196, 198, 200, 202, 206, 207, 212, 213, 214, 216,
    221, 224, 225, 229, 231, 234, 237, 238, 240, 241, 245, 246, 247, 251,
    256, 257, 259, 260, 265, 266, 268, 273, 274, 283, 285, 287, 289, 290,
    291, 292, 298, 299, 301, 303, 304, 306, 308, 311, 315, 321, 322, 324,
    328, 329, 333, 334, 337, 338, 340, 341, 342, 343, 344, 345, 347, 350,
    353, 356, 359, 360, 362, 366, 367, 372, 374, 375, 381, 384, 386, 387,
    388, 391, 396, 399, 400, 401, 405, 406, 408, 411, 412, 414, 417, 418,
    420, 427, 428, 429, 441, 444, 446, 447, 452, 458, 461, 469, 472, 473,
    474, 476, 477, 478, 486, 489, 495, 497,
)

COMBOS = [(b, j, a, s) for b in ("fused", "nonfused")
          for j in ("gather", "matmul") for a in ("segment", "matmul")
          for s in ("torch", "kernel")]


def numpy_result(res):
    return {k: to_np(v) for k, v in res.items()}


def appended_rows(table, lo, hi):
    """Rows ``[lo, hi)`` of a reference table, column by column: key
    columns from the exact int32 view, the rest from the matrix."""
    mat = np.asarray(table.matrix)
    return {c: (np.asarray(table.key(c))[lo:hi] if c in table.keys
                else mat[lo:hi, j]) for j, c in enumerate(table.columns)}


def test_seed_list_is_the_flat_arm_seeds():
    assert SEEDS == tuple(
        s for s in range(500)
        if not any(a.links for a in generate_case(s).query.arms))


@pytest.mark.parametrize("seed", SEEDS)
def test_flat_case_matches_numpy_oracle(seed):
    case = generate_case(seed)
    ref_q = case.query
    tables = dict(case.tables)
    q = port_query(ref_q)
    want = np_oracle(tables, ref_q)
    bad = []
    combos = COMBOS if ref_q.model is not None else COMBOS[:1] + COMBOS[2:3]
    for backend, join, agg, serve in combos:
        res = compile_query(Catalog(port_tables(tables)), q, backend=backend,
                            join_backend=join, agg_backend=agg,
                            serve_backend=serve).run()
        bad += _compare(numpy_result(res), want, ref_q,
                        f"seed={seed} {backend}/{join}/{agg}/{serve}")

    if ref_q.model is not None and ref_q.arms:
        # Serving returns raw predictions per request row: prediction
        # filters live in the aggregate path only.
        ref_qs = dataclasses.replace(ref_q, model_preds=())
        qs = port_query(ref_qs)
        exp = np_serving_oracle(tables, ref_qs)
        fact = port_tables(tables)[q.fact]
        reqs = requests_from_rows(fact, qs, np.arange(int(fact.nvalid)))
        for backend in ("fused", "nonfused"):
            for serve in ("torch", "kernel"):
                rt = compile_serving(Catalog(port_tables(tables)), qs,
                                     backend=backend, serve_backend=serve)
                got = to_np(rt.serve(reqs)).astype(np.float64)
                if not np.array_equal(got, exp):
                    i = int(np.argmax(np.any(got != exp, axis=1)))
                    bad.append(f"seed={seed} serving {backend}/{serve}: "
                               f"row {i} {got[i]} != {exp[i]}")

    bad += rewrite_leg(port_tables(tables), q, tables, ref_q,
                       f"seed={seed}")

    for serve in ("torch", "kernel"):
        res = compile_query(Catalog(port_tables(tables)), q,
                            stream_chunk_rows=16, serve_backend=serve).run()
        bad += _compare(numpy_result(res), want, ref_q,
                        f"seed={seed} stream[16]/{serve}")

    # The append→refresh leg: the delta refresh and a cold compile of the
    # appended catalog must both equal the oracle.
    rng = np.random.default_rng(seed + 1)
    ref_cat = RefCatalog(dict(tables))
    cat = Catalog(port_tables(tables))
    plan = compile_query(cat, q)
    plan.run()
    names = sorted({a.table for a in ref_q.arms} | {ref_q.fact})
    target = names[int(rng.integers(0, len(names)))]
    lo = int(tables[target].nvalid)
    if _append_rows(rng, ref_cat, tables, target):
        cat.append(target, appended_rows(tables[target], lo,
                                         int(tables[target].nvalid)))
        line = plan.refresh()
        assert line.startswith(f"refresh=delta({target}+1;"), line
        want2 = np_oracle(tables, ref_q)
        bad += _compare(numpy_result(plan.run()), want2, ref_q,
                        f"seed={seed} refresh[{target}]")
        bad += _compare(numpy_result(compile_query(cat, q).run()), want2,
                        ref_q, f"seed={seed} cold[{target}]")
    assert not bad, "\n".join(bad[:10])
