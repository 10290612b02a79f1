"""Halo-exchange distributed SpMV — comm/compute-overlapped row partitioning.

The north-star asks for "halo segments of the dense vector exchanged ...
overlapped with local SpMV compute" (BASELINE.md north-star; the reference
itself is single-node, SURVEY §2.6).  ``DistSpMV`` (parallel.spmv) all-gathers
the whole x then computes — strictly sequential, and the gather volume is
n_col per shard regardless of structure.  This module is the structured
alternative:

- x is sharded over the 1-D row mesh; each entry's column has an *owner*.
- At convert time every shard's stream splits into a **local** stream (columns
  it owns) and a **halo** stream (columns it needs from others); the pairwise
  column needs are compiled into one of two static exchange plans, picked by
  a volume+latency cost model:

  * ``rounds`` — ppermute rounds scheduled as greedy size-balanced
    *matchings* over the pairwise-need matrix (not distance keying: distance
    rounds pad every round to its max pair and degrade to R−1 near-dense
    rounds on scattered inputs).
    Each round every shard sends to at most one peer; only nonzero pairs
    are scheduled, and same-sized pairs share a round so the uniform-shape
    padding is tight.  Best when needs are sparse and asymmetric (bands).
  * ``boundary`` — each shard publishes its *boundary set* (the union of
    columns ANY peer needs from it) once, in a single all_gather of shape
    (R, B).  Volume R·B with exactly one collective; hub columns needed by
    many peers are shipped once and broadcast, instead of once per peer.
    Best when needs are dense/overlapping (scattered, power-law) — and its
    worst case equals the plain all-gather, never 10× worse.

- The jitted step issues the exchange first, then computes the local stream's
  SpMV, then the halo stream's: XLA's async collectives overlap the NVLink
  transfer with the local compute (on the CPU test backend collectives are
  synchronous — the win there is the reduced exchange *volume* and collective
  *count*).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import Config
from ..core import hostmem as hm
from ..core.types import COOMatrix, cdiv, round_up
from ..formats import ss as ss_format
from ..ops.segsum import (combine_partials, extract_run_partials,
                          segmented_scan_inclusive)

# exchange-plan cost model: elements-equivalent fixed cost per collective
# (dispatch + synchronization; dominates small halos on both the CPU test
# backend and a real interconnect at microsecond scale)
LAT_ELEMS = 4096
_EMPTY = np.zeros(0, dtype=np.int64)


def _schedule_rounds(needs: dict, R: int):
    """Greedy size-balanced matchings over the nonzero (dst, src) pairs.

    Returns a list of rounds; each round is (pairs, h) with pairs a list of
    (dst, src) and h the round's uniform buffer length (its largest pair).
    Pairs are taken largest-first so similar sizes share a round and the
    pad-to-max waste stays small; every shard appears at most once as dst
    and once as src per round (a partial permutation — valid for ppermute).
    """
    todo = sorted(((int(needs[(s, o)].size), s, o)
                   for (s, o) in needs if needs[(s, o)].size > 0),
                  reverse=True)
    rounds = []
    while todo:
        used_dst, used_src = set(), set()
        taken, rest = [], []
        for sz, s, o in todo:
            if s not in used_dst and o not in used_src:
                taken.append((s, o))
                used_dst.add(s)
                used_src.add(o)
            else:
                rest.append((sz, s, o))
        h = max(needs[(s, o)].size for s, o in taken)
        rounds.append((taken, int(h)))
        todo = rest
    return rounds


@dataclasses.dataclass
class HaloSpMV:
    """Halo-exchanged, overlap-scheduled distributed SpMV over a 1-D row mesh.

    Build with ``HaloSpMV.convert(coo, cfg, mesh)``; apply with ``op(x)``.
    """

    mesh: object
    cfg: Config
    n_row: int
    n_col: int
    nnz: int
    R: int
    rows_per: int
    xs: int                   # x slice length per shard
    mode: str                 # "rounds" | "boundary" | "none"
    balanced: bool            # snake-dealt rows (y reassembled via perm)
    merged: bool              # scattered: own cols ride the boundary table,
    #                           local stream empty (one stream, one combine)
    rounds: tuple             # rounds mode: ((dst,src) pairs, H_r) per round
    bnd_len: int              # boundary mode: B (uniform boundary length)
    local_nnz: int
    halo_nnz: int
    # stacked device arrays, leading dim R
    local_state: dict         # field -> (R, ...) arrays (SS stream, n_col=xs)
    halo_state: dict          # field -> (R, ...) arrays (n_col=halo_total)
    send_idx: tuple           # per round: (R, H_r) int32 local x positions;
    #                           boundary mode: single (R, B) entry
    perm: object              # (R, rows_per) global row ids
    _jitted: object = None

    @staticmethod
    def convert(coo: COOMatrix, cfg: Config, mesh, *,
                row_axis: str = "row", mode: str = "auto") -> "HaloSpMV":
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        axes = dict(zip(mesh.axis_names, mesh.devices.shape))
        R = axes.get(row_axis, 1)

        # Row assignment: contiguous when it is balanced (bands keep row
        # locality, so a shard needs only its neighbours' x slices), else the
        # snake-deal of DistSpMV — an always-contiguous split hands one
        # shard 7× the mean stream on power-law inputs (heavy rows cluster),
        # and the max-shard padding makes every shard pay for it.
        rows_per = cdiv(max(coo.n_row, 1), R)
        xs = cdiv(max(coo.n_col, 1), R)
        cont_s = np.minimum(coo.row // rows_per, R - 1).astype(np.int64)
        counts = np.bincount(cont_s, minlength=R)
        balanced = counts.max(initial=0) > 1.25 * max(counts.mean(), 1.0)
        if balanced:
            from .spmv import partition_rows_balanced

            perm = partition_rows_balanced(coo, R)
            rows_per = perm.shape[1]
            local_of = np.zeros(coo.n_row + 1, dtype=np.int64)
            shard_of = np.zeros(coo.n_row + 1, dtype=np.int64)
            for s in range(R):
                valid = perm[s] < coo.n_row
                local_of[perm[s][valid]] = np.nonzero(valid)[0]
                shard_of[perm[s][valid]] = s
            e_s = shard_of[coo.row]
            e_lr = local_of[coo.row]
        else:
            perm = (np.arange(R)[:, None] * rows_per
                    + np.arange(rows_per)[None, :]).astype(np.int64)
            perm[perm >= coo.n_row] = coo.n_row          # ghost slots
            e_s = cont_s
            e_lr = coo.row - e_s * rows_per
        e_owner = np.minimum(coo.col // xs, R - 1).astype(np.int64)

        # --- pairwise needs: unique cols shard s requires from owner o ------
        needs = {}
        for s in range(R):
            in_s = e_s == s
            for o in range(R):
                if o == s:
                    continue
                m = in_s & (e_owner == o)
                needs[(s, o)] = hm.unique(coo.col[m]) if m.any() else \
                    np.zeros(0, dtype=np.int64)

        # Scattered inputs put most nnz on the halo side; running a separate
        # (max-shard-padded) local stream then costs more than it saves.
        # Merge: own columns ride the gathered boundary table too, and the
        # local stream stays empty — one stream, one combine.
        n_remote = int((e_owner != e_s).sum())
        merged = n_remote > coo.nnz - n_remote
        if merged:
            for s in range(R):
                m = (e_s == s) & (e_owner == s)
                needs[(s, s)] = hm.unique(coo.col[m]) if m.any() else \
                    np.zeros(0, dtype=np.int64)

        # --- exchange plans + cost-model pick -------------------------------
        # (merged mode needs self-delivery, which ppermute has no round for —
        # the gathered boundary table is the only plan that includes own cols)
        pair_needs = {k: v for k, v in needs.items() if k[0] != k[1]}
        rounds = _schedule_rounds(pair_needs, R)
        vol_rounds = sum(h for _, h in rounds)
        cost_rounds = vol_rounds + LAT_ELEMS * len(rounds)

        boundary = {o: (hm.unique(np.concatenate(
                            [needs[(s, o)] for s in range(R)
                             if (s, o) in needs]))
                        if any(needs.get((s, o), _EMPTY).size
                               for s in range(R))
                        else np.zeros(0, dtype=np.int64))
                    for o in range(R)}
        B = max((b.size for b in boundary.values()), default=0)
        cost_boundary = R * B + LAT_ELEMS

        if mode == "auto":
            if vol_rounds == 0 and not merged:
                mode = "none"
            elif merged:
                mode = "boundary"
            else:
                mode = "rounds" if cost_rounds <= cost_boundary else "boundary"
        if merged and mode != "boundary":
            merged = False
            needs = pair_needs

        send_idx = []
        offsets = {}              # (s, o) -> halo-coordinate base for shard s
        if mode == "rounds":
            off = 0
            for pairs, h in rounds:
                arr = np.zeros((R, h), dtype=np.int64)
                for s, o in pairs:
                    cols_need = needs[(s, o)]
                    arr[o, : cols_need.size] = cols_need - o * xs
                    offsets[(s, o)] = off
                send_idx.append(arr)
                off += h
            halo_total = max(off, 1)
        elif mode == "boundary":
            arr = np.zeros((R, max(B, 1)), dtype=np.int64)
            for o, b in boundary.items():
                arr[o, : b.size] = b - o * xs
            send_idx.append(arr)
            for s in range(R):
                for o in range(R):
                    if o != s or merged:
                        offsets[(s, o)] = o * max(B, 1)
            halo_total = max(R * max(B, 1), 1)
        else:
            halo_total = 1

        # --- split each shard's triplets into local / halo streams ---------
        def pack(states, n_col_sub):
            h_needed = max(st.h for st in states)
            r_needed = max(st.r_max for st in states)
            rebuilt = [
                ss_format.build_stream(
                    COOMatrix(n_row=rows_per, n_col=n_col_sub,
                              row=st._rows, col=st._cols, val=st._vals),
                    cfg, min_h=h_needed, min_r_max=r_needed)
                for st in states
            ]
            return {f: np.stack([np.asarray(getattr(st, f)) for st in rebuilt])
                    for f in ("col", "val", "heads", "end_pos", "rank_rows")}

        class _Sub:
            def __init__(self, rows, cols, vals, n_col_sub):
                self._rows, self._cols, self._vals = rows, cols, vals
                st = ss_format.build_stream(
                    COOMatrix(n_row=rows_per, n_col=n_col_sub,
                              row=rows, col=cols, val=vals), cfg)
                self.h, self.r_max = st.h, st.r_max

        local_subs, halo_subs = [], []
        ldt = coo.row.dtype
        for s in range(R):
            in_s = e_s == s
            loc = in_s & (e_owner == s) & (not merged)
            rem = in_s & ~loc
            lr_l = e_lr[loc]
            lc_l = (coo.col[loc] - s * xs).astype(ldt)
            o_l = np.lexsort((lc_l, lr_l))
            local_subs.append(_Sub(lr_l[o_l].astype(ldt), lc_l[o_l],
                                   coo.val[loc][o_l], xs))
            lr_h = e_lr[rem]
            own_h = e_owner[rem]
            cols_h = coo.col[rem]
            # halo coordinate = plan offset + rank of col in the (sorted)
            # per-(s, o) needs list — vectorized searchsorted per owner
            hc = np.zeros(lr_h.size, dtype=np.int64)
            for o in range(R):
                if o == s and not merged:
                    continue
                mo = own_h == o
                if mo.any():
                    ref = boundary[o] if mode == "boundary" else needs[(s, o)]
                    hc[mo] = offsets[(s, o)] + np.searchsorted(ref, cols_h[mo])
            o_h = np.lexsort((hc, lr_h))
            halo_subs.append(_Sub(lr_h[o_h].astype(ldt),
                                  hc[o_h].astype(ldt),
                                  coo.val[rem][o_h], halo_total))

        local_state = pack(local_subs, xs)
        halo_state = pack(halo_subs, halo_total)

        spec = P(row_axis)
        def put(a):
            return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))

        op = HaloSpMV(
            mesh=mesh, cfg=cfg, n_row=coo.n_row, n_col=coo.n_col,
            nnz=coo.nnz, R=R, rows_per=rows_per, xs=xs, mode=mode,
            balanced=bool(balanced), merged=bool(merged),
            rounds=tuple((tuple(p), h) for p, h in rounds)
            if mode == "rounds" else (),
            bnd_len=max(B, 1) if mode == "boundary" else 0,
            local_nnz=int((e_owner == e_s).sum()),
            halo_nnz=int((e_owner != e_s).sum()),
            local_state={k: put(v) for k, v in local_state.items()},
            halo_state={k: put(v) for k, v in halo_state.items()},
            send_idx=tuple(put(a) for a in send_idx),
            perm=jax.device_put(jnp.asarray(perm.reshape(-1)),
                                NamedSharding(mesh, P())),
        )
        op._jitted = op._build(row_axis)
        return op

    def _build(self, row_axis: str):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        try:
            from jax import shard_map
        except ImportError:  # older jax
            from jax.experimental.shard_map import shard_map

        mesh, R, xs = self.mesh, self.R, self.xs
        rows_per, rounds, mode = self.rows_per, self.rounds, self.mode
        merged = self.merged

        def ss_apply(st, x_all):
            col, val = st["col"][0], st["val"][0]
            heads, end_pos = st["heads"][0], st["end_pos"][0]
            rank_rows = st["rank_rows"][0]
            prod = val * x_all[col]
            scanned = segmented_scan_inclusive(prod, heads.astype(bool))
            partials = extract_run_partials(scanned, end_pos)
            return combine_partials(partials, rank_rows, rows_per)

        # ppermute perm: list of (src, dst) pairs; rounds store (dst, src)
        perm_pairs = [[(o, s) for s, o in pairs] for pairs, _ in rounds]

        def body(local_st, halo_st, send_idx, x_loc):
            # 1) issue the exchange first — async collectives start here
            recvs = []
            if mode == "rounds":
                for pp, sidx in zip(perm_pairs, send_idx):
                    send = x_loc[sidx[0]]
                    recvs.append(jax.lax.ppermute(send, row_axis, perm=pp))
            elif mode == "boundary":
                send = x_loc[send_idx[0][0]]                  # (B,)
                gathered = jax.lax.all_gather(send, row_axis)  # (R, B)
                recvs.append(gathered.reshape(-1))
            # 2) local compute overlaps the in-flight exchanges
            #    (merged mode has no local stream — everything is step 3)
            y = None if merged else ss_apply(local_st, x_loc)
            # 3) halo compute consumes the received segments
            if recvs:
                x_halo = jnp.concatenate(recvs) if len(recvs) > 1 else recvs[0]
                yh = ss_apply(halo_st, x_halo)
                y = yh if y is None else y + yh
            return y[None]

        grid = P(row_axis)
        sharded = shard_map(
            body, mesh=mesh,
            in_specs=({k: grid for k in self.local_state},
                      {k: grid for k in self.halo_state},
                      tuple(grid for _ in self.send_idx), grid),
            out_specs=grid,
            check_vma=False,
        )

        n_col_pad = xs * R
        n_row, balanced = self.n_row, self.balanced

        @jax.jit
        def run(local_st, halo_st, send_idx, perm, x):
            xp = jnp.zeros((n_col_pad,), x.dtype).at[: x.shape[0]].set(x)
            y_perm = sharded(local_st, halo_st, send_idx, xp).reshape(-1)
            if balanced:
                # snake-dealt rows: one inverse-permutation scatter-add
                # (ghost slots target the n_row bin and are dropped)
                y = jnp.zeros((n_row + 1,), y_perm.dtype)
                return y.at[perm].add(y_perm)[:n_row]
            # contiguous partition: shard-order concat IS global row order
            return y_perm[:n_row]

        return run

    def __call__(self, x):
        import jax.numpy as jnp

        x = jnp.asarray(np.asarray(x, dtype=self.cfg.np_dtype))
        return self._jitted(self.local_state, self.halo_state, self.send_idx,
                            self.perm, x)

    @property
    def exchange_elems(self) -> int:
        """Per-shard exchanged x elements per SpMV (vs n_col for all-gather)."""
        if self.mode == "boundary":
            return self.R * self.bnd_len
        return sum(h for _, h in self.rounds)

    @property
    def n_collectives(self) -> int:
        if self.mode == "boundary":
            return 1
        return len(self.rounds)
