"""POET-analogue coupled reactive transport with the DHT as surrogate model,
on the PyTorch port (twin of ``examples/poet_reactive_transport.py``: the
plain DHT path, ``--interp`` and ``--pipeline``).

Physics: a 2-D grid, explicit upwind advection with constant flux and
magnesium chloride injected at the top-left boundary; per-cell kinetic
chemistry (the PHREEQC stand-in) as a deliberately expensive damped
fixed-point solver for calcite dissolution and dolomite precipitation.

Surrogate integration as in the paper: the 9 species + dt are rounded to
``sig_digits`` significant digits -> 80-byte DHT key; the value is the
exact 13-value solver output (104 bytes).  Cells are deduplicated on the
host, looked up in fixed-size padded batches, and only the misses go to
the solver, whose results are written back.  With ``--interp`` each
lookup is a neighbourhood query (``lookup_or_interpolate``): a cell whose
own rounded state is not cached but whose lattice neighbours are takes
their inverse-distance blend instead of a solver call.  With
``--pipeline`` the lookups go through ``lookup_or_compute_pipelined``:
the read round of bucket B+1 is issued before the solver computes
bucket B's misses, so the round runs on the card while the host waits on
the chemistry.

    PYTHONPATH=src python examples/torch_poet_reactive_transport.py \
        [--interp | --pipeline] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import (
    PROV_EXACT,
    PROV_MISS,
    DHTConfig,
    InterpConfig,
    SurrogateConfig,
    dht_read,
    dht_write,
    lookup_or_compute_pipelined,
    lookup_or_interpolate,
    make_keys,
    pack_floats,
    surrogate_create,
)
from repro_torch.core.layout import resolve_device

N_IN = 10    # 9 species + dt        -> 80-byte key  (paper §5.4)
N_OUT = 13   # 9 new species + 4 rate diagnostics -> 104-byte value

# species vector layout
MG, CA, CL, CO3, H, ALK, CALCITE, DOLOMITE, TEMP = range(9)

READ_BUCKET, MISS_BUCKET = 2048, 512


@dataclasses.dataclass
class PoetConfig:
    nx: int = 50
    ny: int = 150
    n_steps: int = 50
    dt: float = 0.25
    vx: float = 0.35           # advection velocity (cells/step, x)
    vy: float = 0.18
    sig_digits: int = 3
    # kinetic sub-stepping depth: per-cell chemistry as costly as a
    # PHREEQC call
    solver_iters: int = 2000
    dht_mode: str = "lockfree"
    dht_shards: int = 8
    dht_buckets: int = 1 << 14
    inj_mg: float = 2.0        # injected MgCl2
    inj_cl: float = 4.0
    # neighbourhood queries: resolve near-miss states by IDW interpolation
    # over cached lattice neighbours instead of the solver
    use_interp: bool = False
    interp_radius: int = 1
    interp_max_dist: float = 2.0
    interp_min_neighbors: int = 2
    # pipelined issue/commit engine: probe the next read bucket while the
    # solver computes the previous bucket's misses
    use_pipeline: bool = False
    pipeline_depth: int = 2


def initial_state(cfg: PoetConfig, device) -> torch.Tensor:
    """(nx*ny, 9) equilibrated calcite-bearing state."""
    s = torch.zeros((cfg.nx * cfg.ny, 9), dtype=torch.float32, device=device)
    s[:, MG] = 1e-3
    s[:, CA] = 0.4
    s[:, CL] = 1e-3
    s[:, CO3] = 0.4
    s[:, H] = 1e-7
    s[:, ALK] = 0.8
    s[:, CALCITE] = 1.0
    s[:, DOLOMITE] = 0.0
    s[:, TEMP] = 25.0
    return s


def chemistry(inputs: torch.Tensor, iters: int = 60) -> torch.Tensor:
    """(n, 10) [species(9), dt] -> (n, 13) [species'(9), rates(4)]:
    damped fixed-point iteration on calcite/dolomite kinetics."""
    s = inputs[:, :9].to(torch.float32)
    dt = inputs[:, 9]
    k_cal, k_dol = 8.0, 4.8
    K_cal, K_dol = 0.16, 0.02
    scale = dt / iters
    st = s.clone()
    for _ in range(iters):
        mg, ca, co3 = st[:, MG], st[:, CA], st[:, CO3]
        cal, dol = st[:, CALCITE], st[:, DOLOMITE]
        omega_cal = (ca * co3) / K_cal
        omega_dol = (ca * mg * co3 * co3) / K_dol
        r_cal = k_cal * (1.0 - omega_cal)            # >0: dissolution
        r_cal = torch.where(cal <= 0.0, torch.clamp(r_cal, max=0.0), r_cal)
        r_dol = k_dol * (omega_dol - 1.0)            # >0: precipitation
        r_dol = torch.where(dol <= 0.0, torch.clamp(r_dol, min=0.0), r_dol)
        d_cal = -r_cal * scale
        d_dol = r_dol * scale
        new = st.clone()
        new[:, CALCITE] = torch.clamp(cal + d_cal, min=0.0)
        new[:, DOLOMITE] = torch.clamp(dol + d_dol, min=0.0)
        new[:, CA] = torch.clamp(ca - d_cal - d_dol, min=1e-9)
        new[:, MG] = torch.clamp(mg - d_dol, min=1e-9)
        new[:, CO3] = torch.clamp(co3 - d_cal - 2 * d_dol, min=1e-9)
        new[:, ALK] = torch.clamp(new[:, CO3] * 2.0, min=1e-9)
        st = new
    mg, ca, co3 = st[:, MG], st[:, CA], st[:, CO3]
    rates = torch.stack([
        (ca * co3) / K_cal,
        (ca * mg * co3 * co3) / K_dol,
        st[:, CALCITE] - s[:, CALCITE],
        st[:, DOLOMITE] - s[:, DOLOMITE],
    ], dim=-1)
    return torch.cat([st, rates], dim=-1)


def advect(state: torch.Tensor, nx: int, ny: int, vx: float, vy: float,
           inj_mg: float, inj_cl: float) -> torch.Tensor:
    """Explicit upwind advection of the solutes plus constant injection."""
    g = state.reshape(nx, ny, 9).clone()
    for sp in (MG, CA, CL, CO3, H, ALK):
        c = g[:, :, sp]
        up_x = torch.cat([c[:1, :], c[:-1, :]], dim=0)
        up_y = torch.cat([c[:, :1], c[:, :-1]], dim=1)
        g[:, :, sp] = c - vx * (c - up_x) - vy * (c - up_y)
    inj_x, inj_y = max(nx // 16, 1), max(ny // 16, 1)
    g[:inj_x, :inj_y, MG] = inj_mg
    g[:inj_x, :inj_y, CL] = inj_cl
    return g.reshape(nx * ny, 9)


# the reference's jitted ``round(x * 1e6) / 1e6`` compiles the division
# by a constant into a product with its f32 reciprocal; so does this
_INV_1E6 = float(np.float32(1.0) / np.float32(1e6))


def group_key(x: torch.Tensor) -> torch.Tensor:
    """Pre-grouping key: rounded to fixed decimals, finer than the
    sig-digit key rounding, so grouping never merges distinct keys."""
    return torch.round(x * 1e6) * torch.tensor(
        _INV_1E6, dtype=torch.float32, device=x.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bucketed_lookup(cfg, scfg, icfg, table, uniq_rows, dev):
    """One step's lookups in fixed-size padded buckets, then the misses
    through the solver in buckets and written back.  Returns
    ``(outputs, found, exact, solver calls, mismatches)``."""
    nu = uniq_rows.shape[0]
    out_u = np.zeros((nu, N_OUT), np.float32)
    found_np = np.zeros((nu,), bool)
    exact_np = np.zeros((nu,), bool)
    chem_calls = mismatches = 0
    for lo in range(0, nu, READ_BUCKET):
        hi_ = min(lo + READ_BUCKET, nu)
        upad = np.zeros((READ_BUCKET, N_IN), np.float32)
        upad[: hi_ - lo] = uniq_rows[lo:hi_]
        uvalid = torch.zeros(READ_BUCKET, dtype=torch.bool, device=dev)
        uvalid[: hi_ - lo] = True
        x = torch.from_numpy(upad).to(dev)
        if cfg.use_interp:
            # exact hit, or IDW over cached lattice neighbours: both skip
            # the solver for this row
            table, out_f, prov, rstats = lookup_or_interpolate(
                scfg, table, x, icfg, valid=uvalid)
            pv = prov[: hi_ - lo].cpu().numpy()
            found_np[lo:hi_] = pv != PROV_MISS
            exact_np[lo:hi_] = pv == PROV_EXACT
            out_u[lo:hi_] = out_f[: hi_ - lo].cpu().numpy()
        else:
            table, vals_w, found, rstats = dht_read(
                table, make_keys(scfg, x), uvalid)
            found_np[lo:hi_] = found[: hi_ - lo].cpu().numpy()
            exact_np[lo:hi_] = found_np[lo:hi_]
            vw = vals_w[: hi_ - lo].cpu().numpy()
            out_u[lo:hi_] = np.ascontiguousarray(
                vw[:, 0:2 * N_OUT:2]).view(np.float32)
        mismatches += int(rstats["mismatches"])
    miss_idx = np.nonzero(~found_np)[0]
    for lo in range(0, miss_idx.size, MISS_BUCKET):
        sel = miss_idx[lo:lo + MISS_BUCKET]
        pad = np.zeros(MISS_BUCKET, np.int64)
        pad[: sel.size] = sel
        sub_in = torch.from_numpy(uniq_rows[pad]).to(dev)
        sub = chemistry(sub_in, cfg.solver_iters)
        chem_calls += int(sel.size)
        out_u[sel] = sub[: sel.size].cpu().numpy()
        valid = torch.zeros(MISS_BUCKET, dtype=torch.bool, device=dev)
        valid[: sel.size] = True
        table, _ = dht_write(table, make_keys(scfg, sub_in),
                             pack_floats(sub, scfg.dht.val_words), valid)
    return out_u, found_np, exact_np, chem_calls, mismatches


def _pipelined_lookup(cfg, scfg, table, uniq_rows, dev):
    """One step's lookups through the pipelined driver: bucket B+1's read
    round is in flight while the solver computes bucket B's misses.  As
    in the reference example, the solver takes a whole bucket whenever
    it holds a miss.  Returns ``(outputs, found, solver calls)``."""
    nu = uniq_rows.shape[0]
    batches = [torch.from_numpy(uniq_rows[lo:lo + READ_BUCKET]).to(dev)
               for lo in range(0, nu, READ_BUCKET)]
    chem_calls = 0

    def chem_counted(x):
        nonlocal chem_calls
        chem_calls += int(x.shape[0])
        return chemistry(x, cfg.solver_iters)

    _, outs, founds, _ = lookup_or_compute_pipelined(
        scfg, table, batches, chem_counted, depth=cfg.pipeline_depth)
    out_u = torch.cat(outs).cpu().numpy()
    found_np = torch.cat(founds).cpu().numpy()
    return out_u, found_np, chem_calls


def run_simulation(cfg: PoetConfig, use_dht: bool = True, *,
                   device: str | torch.device | None = None,
                   verbose: bool = False) -> dict:
    dev = resolve_device(device)
    n = cfg.nx * cfg.ny
    state = initial_state(cfg, dev)
    scfg = SurrogateConfig(
        n_inputs=N_IN, n_outputs=N_OUT, sig_digits=cfg.sig_digits,
        dht=DHTConfig(key_words=20, val_words=26, n_shards=cfg.dht_shards,
                      buckets_per_shard=cfg.dht_buckets, mode=cfg.dht_mode))
    table = surrogate_create(scfg, device=dev)
    icfg = InterpConfig(
        radius=cfg.interp_radius, max_neighbor_dist=cfg.interp_max_dist,
        min_neighbors=cfg.interp_min_neighbors)
    hits = interp_hits = misses = chem_calls = mismatches = 0

    # warm-up outside the timed loop: builds the kernels on the card
    if use_dht:
        none = torch.zeros(READ_BUCKET, dtype=torch.bool, device=dev)
        wk = torch.zeros((READ_BUCKET, N_IN), dtype=torch.float32, device=dev)
        if cfg.use_interp:
            table, *_ = lookup_or_interpolate(scfg, table, wk, icfg,
                                              valid=none)
        table, *_ = dht_read(table, make_keys(scfg, wk), none)
        table, _ = dht_write(
            table, make_keys(scfg, wk), torch.zeros(
                (READ_BUCKET, scfg.dht.val_words), dtype=torch.int32,
                device=dev), none)
    _sync(dev)

    t_chem = 0.0
    t0 = time.perf_counter()
    for step in range(cfg.n_steps):
        state = advect(state, cfg.nx, cfg.ny, cfg.vx, cfg.vy,
                       cfg.inj_mg, cfg.inj_cl)
        inputs = torch.cat(
            [state, torch.full((n, 1), cfg.dt, dtype=torch.float32,
                               device=dev)], dim=1)
        tc = time.perf_counter()
        if not use_dht:
            out = chemistry(inputs, cfg.solver_iters)
            chem_calls += n
        else:
            # one DHT request per distinct cell state: dedup on the host
            rounded = group_key(inputs).cpu().numpy()
            uniq_rows, inv = np.unique(rounded, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            if cfg.use_pipeline and not cfg.use_interp:
                out_u, found_np, n_chem = _pipelined_lookup(
                    cfg, scfg, table, uniq_rows, dev)
                # forwarded rows count as exact hits, like the synchronous
                # schedule they equal bit for bit
                exact_np = found_np
            else:
                out_u, found_np, exact_np, n_chem, n_mm = _bucketed_lookup(
                    cfg, scfg, icfg, table, uniq_rows, dev)
                mismatches += n_mm
            chem_calls += n_chem
            # per-cell accounting (the paper counts per-request hits)
            hits += int(exact_np[inv].sum())
            interp_hits += int((found_np & ~exact_np)[inv].sum())
            misses += int((~found_np[inv]).sum())
            out = torch.from_numpy(out_u[inv]).to(dev)
        _sync(dev)
        t_chem += time.perf_counter() - tc
        state = out[:, :9]
        if verbose and step % 10 == 0:
            print(f"step {step:4d} calcite "
                  f"{float(state[:, CALCITE].mean()):.4f} dolomite "
                  f"{float(state[:, DOLOMITE].mean()):.4f} "
                  f"hits {hits} misses {misses}")
    _sync(dev)
    wall = time.perf_counter() - t0
    total = hits + interp_hits + misses
    return {
        "conc": state,
        "wall_s": wall,
        "chem_s": t_chem,
        "chem_calls": chem_calls,
        "hit_rate": (hits + interp_hits) / total if total else 0.0,
        "exact_hit_rate": hits / total if total else 0.0,
        "hits": hits,
        "interp_hits": interp_hits,
        "misses": misses,
        "mismatches": mismatches,
        "grid": (cfg.nx, cfg.ny),
        "steps": cfg.n_steps,
        "device": str(dev),
    }


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--interp", action="store_true",
                    help="resolve near-miss states by stencil interpolation "
                         "over cached lattice neighbours")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined issue/commit engine: probe the next "
                         "read bucket while the solver computes the "
                         "previous bucket's misses")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args()

    cfg = PoetConfig(use_interp=args.interp, use_pipeline=args.pipeline)
    print(f"grid {cfg.nx}x{cfg.ny}, {cfg.n_steps} steps, "
          f"sig_digits={cfg.sig_digits}, interp={cfg.use_interp}, "
          f"pipeline={cfg.use_pipeline}, device={args.device}")
    ref = run_simulation(cfg, use_dht=False, device=args.device)
    print(f"reference (no DHT): {ref['wall_s']:.2f}s "
          f"({ref['chem_calls']} chemistry calls)")
    dht = run_simulation(cfg, use_dht=True, device=args.device, verbose=True)
    extra = (f", {dht['interp_hits']} interpolated"
             if cfg.use_interp else "")
    print(f"with lock-free DHT: {dht['wall_s']:.2f}s "
          f"({dht['chem_calls']} chemistry calls, "
          f"hit rate {dht['hit_rate'] * 100:.1f}%"
          f" [exact {dht['exact_hit_rate'] * 100:.1f}%]{extra})")
    gain = (ref["wall_s"] - dht["wall_s"]) / ref["wall_s"] * 100
    print(f"performance gain: {gain:.1f}%")
    err = float((dht["conc"] - ref["conc"]).abs().max())
    print(f"max |dconc| vs reference: {err:.2e} (rounding-controlled)")


if __name__ == "__main__":
    main()
