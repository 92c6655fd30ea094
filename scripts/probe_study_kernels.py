#!/usr/bin/env python3
"""What the redesigned kernel-study kernels K7 and K4 (with K3/K5, which
share its stream) are made of: altered copies, each timed beside the
unaltered kernel on one card.

    python3 scripts/probe_study_kernels.py [--probes j2,j4,u3,ring2x16,copy_forms,...]

Each altered copy is a text substitution of ``csrc/tile_rmw.cu`` or
``csrc/onehot_adam.cu`` (``PROBES``), built into ``csrc/build/exp/<probe>/``
(git-ignored), held equal to the unaltered kernel's output and timed kernel
alone (chip_smoke.py's ``graph_ms``: 20 launches in a CUDA graph, the
replay timed) beside the unaltered kernel in turns (base, altered, altered,
base), at chip_smoke.py phase 2b's shapes:

* ``j2`` ... ``j8``: K7 with J (``GROUP``), the jobs a warp has in flight
  (the source's is 1); ``rmw_stcs``: its row stores with the streaming
  hint; each warm and cold (``cold_ms``: L2 flushed before each launch);
* ``u3``, ``u4``: the one-hot row stream with U = 3 or 4 rows in registers
  (``AHEAD`` 2 or 3 rows loaded ahead; the source's U is 2);
  ``rows_nohint``: that stream without its cache hints; ``ring<S>x<KB>``:
  COPY's TMA ring at S stages of KB each (the source's is 4 x 32);
  ``tma_evict_first``: its bulk loads marked evict-first in L2 too;
  ``tma_store_plain``: its bulk stores without that mark.  Each times
  K4 ``copy``, ``sweep`` and ``dot_bf16``, K3 and K5 (f32 copy);
* ``copy_forms``: K4's copy by the COPY mode (TMA) beside the vector
  stream of ``scripts/probes/copy_vector.cu``, with ``torch.stack``'s
  kernels and the times of one-call copies as yardsticks;
* ``rmw_rows``: K7 and ``index_add_`` cold on the bench's scattered rows
  and on as many contiguous rows.

The ptxas register lines of every build are printed.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBES = {
    # K7: J jobs a warp has in flight (the source's is 1), a streaming store
    **{f"j{j}": ("tile_rmw", (("#define GROUP 1", f"#define GROUP {j}"),)) for j in (2, 4, 6, 8)},
    "rmw_stcs": ("tile_rmw", (("tab[(long long)row[k] * 32 + lane] = x[k];",
                               "__stcs(tab + (long long)row[k] * 32 + lane, x[k]);"),)),
    # the one-hot row stream: U rows in registers (the source's is 2), no hints
    "u3": ("onehot_adam", (("#define AHEAD 1", "#define AHEAD 2"),)),
    "u4": ("onehot_adam", (("#define AHEAD 1", "#define AHEAD 3"),)),
    "rows_nohint": ("onehot_adam", (("constexpr bool FRESH = PC == PC_NONE;",
                                     "constexpr bool FRESH = false;"),)),
    # COPY's TMA ring (the source's is 4 stages of 32 KB), its loads marked
    # evict-first in L2
    **{f"ring{st}x{kb}": ("onehot_adam", (
        ("#define COPY_STAGES 4", f"#define COPY_STAGES {st}"),
        ("#define COPY_CHUNK (32 * 1024)", f"#define COPY_CHUNK ({kb} * 1024)")))
       for st, kb in ((2, 16), (4, 16), (2, 32), (3, 48), (4, 48))},
    "tma_evict_first": ("onehot_adam", ((
        '"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "\n'
        '        "[%3];\\n"',
        '"{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"\n'
        '        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "\n'
        '        "[%0], [%1], %2, [%3], pol;\\n}\\n"'),)),
    "tma_store_plain": ("onehot_adam", (
        ("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;",
         "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"),
        (', "l"(evict_first)\n', "\n"))),
}


def _altered(name, probe, subs):
    """Build ``csrc/<name>.cu`` with ``subs`` applied; returns its library."""
    from shine_mapping_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC_DIR, f"{name}.cu")) as f:
        text = f.read()
    for a, b in subs:
        assert a in text, f"{probe}: '{a}' not in {name}.cu"
        text = text.replace(a, b)
    lib_dir = os.path.join(cuda_build.BUILD_DIR, "exp", probe)
    os.makedirs(lib_dir, exist_ok=True)
    with open(os.path.join(lib_dir, f"{name}.cu"), "w") as f:
        f.write(text)
    lib = cuda_build.load(name, lib_dir, lib_dir)
    _print_ptxas(os.path.relpath(os.path.join(lib_dir, name), cuda_build.CSRC_DIR), probe)
    return lib


def _print_ptxas(key, label):
    """The registers / shared memory of each kernel of a build."""
    from shine_mapping_tpu_torch.ops import cuda_build

    fn = ""
    for line in cuda_build.BUILD_INFO[key]["log"].splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1][:60]
        elif "registers" in line:
            print(f"[ptxas] {label} {fn}: {line.split(':', 1)[1].strip()}")


def _turns(base, alt, timer):
    import chip_smoke as cs

    return cs._in_turns(base, alt, timer)


def probe_rmw(probe, lib, T=262144, N=32768):
    import numpy as np
    import torch

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import tile_rmw as tr

    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((T, 128)).astype(np.float32)).cuda()
    tiles = torch.from_numpy(np.sort(rng.choice(T, N, replace=False)).astype(np.int32)).cuda()
    deltas = torch.from_numpy(rng.standard_normal((N, 128)).astype(np.float32)).cuda()
    fn = tr.c_entry(lib)
    a, b = table.clone(), table.clone()
    tr.launch(a, tiles, deltas)
    tr.launch(b, tiles, deltas, fn)
    torch.cuda.synchronize()
    assert torch.equal(a, b), f"{probe}: output differs"
    for label, timer in (("warm", cs.graph_ms), ("cold", cs.cold_ms)):
        t_b, t_a = _turns(lambda: tr.launch(a, tiles, deltas),
                          lambda: tr.launch(a, tiles, deltas, fn), timer)
        print(f"[probe] {probe} K7 {label}: base {t_b:.4f} ms, altered {t_a:.4f} ms "
              f"({t_a / t_b - 1:+.1%})")


def probe_rmw_rows(T=262144, N=32768):
    """K7 cold with the bench's rows (sorted, unique, one in eight of the
    table's) against the same jobs on the table's first N rows (one
    contiguous 16 MB block), and index_add_ on both: what scattered 512-byte
    rows cost the DRAM."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import tile_rmw as tr

    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((T, 128)).astype(np.float32)).cuda()
    deltas = torch.from_numpy(rng.standard_normal((N, 128)).astype(np.float32)).cuda()
    for label, rows in (("scattered", np.sort(rng.choice(T, N, replace=False))),
                        ("contiguous", np.arange(N))):
        tiles = torch.from_numpy(rows.astype(np.int32)).cuda()
        t_k = cs.cold_ms(lambda: tr.launch(table, tiles, deltas))
        t_l = cs.cold_ms(lambda: table.index_add_(0, tiles.long(), deltas))
        print(f"[probe] K7 cold, {label} rows: kernel alone {t_k:.4f} ms, index_add_ "
              f"{t_l:.4f} ms")


def _onehot_inputs(C=1 << 22, M=65536):
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    D = 8
    base = [torch.from_numpy(a).cuda() for a in (
        rng.normal(0, 1, (C, D)).astype(np.float32),
        rng.normal(0, 1e-3, (C, D)).astype(np.float32),
        np.abs(rng.normal(0, 1e-4, (C, D))).astype(np.float32))]
    rows = torch.from_numpy(np.sort(rng.integers(0, C - 1, M)).astype(np.int32)).cuda()
    grads = torch.from_numpy(rng.normal(0, 1e-3, (M, D)).astype(np.float32)).cuda()
    return base, rows, grads


def _onehot_cases(base, rows, grads):
    """(label, launch(fn, outs), outs) at phase 2b's shapes."""
    import torch

    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    C, M = base[0].shape[0], rows.shape[0]
    R = C * 8 // 128
    lr, bc1, bc2 = 0.01, 1 - 0.9 ** 5, 1 - 0.99 ** 5
    scal = torch.tensor([lr, bc1, bc2, 0.0], device="cuda")
    cases = []
    tb, w = 256, 256
    offs3 = oa.window_offsets((rows // oa.PACK).to(torch.int32), R // tb, tb, w,
                              oa.padded_len(M, w))
    win = oa.window_inputs(rows, grads, C, tb, w)
    Mpad = win[0].shape[1]
    for variant in ("copy", "sweep", "dot_bf16"):
        cases.append((f"K4 {variant}", lambda fn, outs, v=variant: oa._launch(
            oa._MODE[v], 0, *base, *outs, None, *win, scal, 0.0, 1.0, 1.0, R // tb, tb, w,
            Mpad, oa.B1, oa.B2, oa.EPS, fn=fn), 3))
    cases.append(("K3", lambda fn, outs: oa._launch(
        oa._MODE["narrow"], 0, *base, *outs, None, rows, grads, None, offs3, None, lr, bc1, bc2,
        R // tb, tb, w, M, oa.B1, oa.B2, oa.EPS, fn=fn), 3))
    tb5, w5 = oa.choose_tiles(C, 8, M)
    win5 = oa.window_inputs(rows, grads, C, tb5, w5)
    cases.append(("K5 f32", lambda fn, outs: oa._launch(
        oa._MODE["dot_bf16"], oa._COPY[torch.float32], *outs[:3], *outs[:3], outs[3], *win5,
        scal, 0.0, 1.0, 1.0, R // tb5, tb5, w5, win5[0].shape[1], oa.B1, oa.B2, oa.EPS,
        fn=fn), 4))
    return cases


def probe_onehot(probe, lib):
    import torch

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import onehot_adam as oa

    base, rows, grads = _onehot_inputs()
    fn = oa.c_entry(lib)
    for label, launch, n_out in _onehot_cases(base, rows, grads):
        def outs():  # K5 updates copies of the tables in place, plus its copy of p
            o = [x.clone() for x in base] if n_out == 4 else [torch.empty_like(x) for x in base]
            return o + [torch.empty_like(base[0])] if n_out == 4 else o
        a, b = outs(), outs()
        launch(None, a)
        launch(fn, b)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"{probe} {label}: output differs"
        t_b, t_a = _turns(lambda: launch(None, a), lambda: launch(fn, a), cs.graph_ms)
        print(f"[probe] {probe} {label}: base {t_b:.4f} ms, altered {t_a:.4f} ms "
              f"({t_a / t_b - 1:+.1%})")
        del a, b
        torch.cuda.empty_cache()


def probe_copy_forms():
    """K4's copy in its two forms, kernel alone in turns: the COPY mode (TMA
    bulk copies) and the 16-byte vector stream of
    ``scripts/probes/copy_vector.cu``; beside them what ``torch.stack((p,
    m, v))`` runs (its device kernels by name, from torch.profiler) and the
    times of one-call copies: ``torch.stack``, three ``Tensor.copy_``
    (device-to-device memory copies) and one ``copy_`` of a stacked buffer."""
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from shine_mapping_tpu_torch.ops import cuda_build

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probes")
    lib = cuda_build.load("copy_vector", here, os.path.join(cuda_build.BUILD_DIR, "exp", "vec"))
    _print_ptxas(os.path.relpath(os.path.join(here, "copy_vector"), cuda_build.CSRC_DIR),
                 "copy_vector")
    fn = lib.copy_vector
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    base, rows, grads = _onehot_inputs()
    launch = _onehot_cases(base, rows, grads)[0][1]  # K4 copy
    outs = [torch.empty_like(x) for x in base]

    def vector():
        err = fn(*(x.data_ptr() for x in base), *(x.data_ptr() for x in outs),
                 base[0].numel() * 4, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"copy_vector launch failed: CUDA error {err}"

    for form in (vector, lambda: launch(None, outs)):
        for x in outs:
            x.zero_()
        form()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(outs, base)), "a copy differs"
    t_vec, t_tma = _turns(vector, lambda: launch(None, outs), cs.graph_ms)
    print(f"[probe] copy forms, kernel alone in turns: TMA (the COPY mode) {t_tma:.4f} ms, "
          f"vector stream {t_vec:.4f} ms ({t_tma / t_vec - 1:+.1%}); bound "
          f"{24 * base[0].numel() / 3.35e12 * 1e3:.4f} ms")
    stacked = torch.stack(base)
    dst = torch.empty_like(stacked)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.stack(base)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if t > 0:
            print(f"[probe] torch.stack runs: {e.key[:100]} x{e.count}, {t / 1e3:.4f} ms")
    t_stack = cs.graph_ms(lambda: torch.stack(base))
    t_three = cs.graph_ms(lambda: [o.copy_(x) for o, x in zip(outs, base)])
    t_one = cs.graph_ms(lambda: dst.copy_(stacked))
    print(f"[probe] yardsticks, kernel alone: torch.stack {t_stack:.4f} ms, three copy_ "
          f"{t_three:.4f} ms, one copy_ of the stacked tables {t_one:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probes", default=",".join([*PROBES, "copy_forms", "rmw_rows"]))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_study_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"{torch.cuda.get_device_name(0)}; kernel alone, phase 2b's shapes")
    from shine_mapping_tpu_torch.ops import cuda_build

    for name in ("tile_rmw", "onehot_adam"):
        cuda_build.load(name)
        _print_ptxas(name, "base")
    for probe in args.probes.split(","):
        if probe in ("copy_forms", "rmw_rows"):
            (probe_copy_forms if probe == "copy_forms" else probe_rmw_rows)()
            continue
        name, subs = PROBES[probe]
        lib = _altered(name, probe, subs)
        (probe_rmw if name == "tile_rmw" else probe_onehot)(probe, lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
