"""Regenerating-code constructions behind the `msr-pm` codec: the
port's copy of minio_tpu/ops/regen.py, numpy only, byte for byte the
same matrices and repair plans.

Repair-bandwidth-optimal erasure matrices whose single-shard repair
reads only a β-slice from each helper instead of k whole shards.

Construction note (why this is NOT a literal product-matrix code even
though the codec id keeps the `msr-pm` name): product-matrix MSR
(arXiv 1412.3022) is bandwidth-optimal on the WIRE but not
access-optimal on DISK — every helper reads its full α-symbol shard to
compute the β-symbol projection it ships. The byte-flow this subsystem
is judged by (bytes read per byte healed) counts disk reads, so a
product-matrix construction could never beat ratio d ≥ 2k-2 there. The
main arm here is therefore a *coupled-layer* MSR construction in the
Clay-code family (Ye-Barg / Vajha et al.): helpers READ exactly
β = α/q sub-shards — pure selection, no local projection — and the
ratio for one lost shard is (n-1)/m, e.g. 1.75 at 4+4 versus the
dense-RS 4.0. High-rate geometries whose sub-packetization q^t would
blow past `_ALPHA_CAP` (the 12+4 class: α would be 4^4 = 256) fall back
to a piggybacked-RS arm (piggybacking framework, arXiv 1311.2262
flavor) with α = 2 that still cuts data-shard repair from k shards to
(k + |group|)/2.

Both arms are *derived and verified numerically at construction time*:
the coupled-layer generator matrix is solved from the plane/coupling
linear system over GF(2^8), then the systematic identity, the MDS
property (every k-subset of node row-blocks invertible), and every
node's repair plan are checked before the geometry is admitted —
a geometry/γ pair that fails any check is rejected loudly, never served.

The on-disk layout needs no new format: a shard of S bytes is treated as
α interleaved sub-shards of S/α bytes (sub-shard s of node i is the
contiguous byte range [s·S/α, (s+1)·S/α)). A buffer viewed from
[k, S] as [k·α, S/α] is byte-identical, so the expanded matrices ride
kernel A (ops/rs.apply_gf_matrix) unchanged; erasure/device_engine.py
applies that view around every matrix apply.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass

import numpy as np

from . import cauchy, gf

# Sub-packetization ceiling for the coupled-layer arm. The generator is
# solved from an (n'·α)² GF(2^8) system at construction time; α = q^t
# grows exponentially in t, and past 32 the one-time solve (and the
# expanded-matrix encode cost, which scales ×α over dense RS) stops
# being worth the repair savings — those geometries take the α=2
# piggyback arm instead.
_ALPHA_CAP = 32

# Coupling coefficients tried for the coupled-layer pair transform.
# γ ∉ {0, 1} keeps every 2×2 pair matrix [[1, γ], [γ, 1]] invertible in
# characteristic 2 (det = (1+γ)²); the MDS property additionally needs
# γ off a small bad set, so the constructor searches this list and
# keeps the first γ whose full verification passes.
_GAMMA_CANDIDATES = (2, 3, 4, 5, 6, 7, 9, 11, 13, 19)

# MDS verification budget: exhaustive k-subset check below this many
# subsets, deterministic sampling above it.
_MDS_EXHAUSTIVE_LIMIT = 128
_MDS_SAMPLES = 64


class RegenGeometryError(ValueError):
    """A geometry this module cannot (or refused to) construct —
    subclasses ValueError so the codec layer's singular-matrix handling
    maps it to ErrTooFewShards-style loud failures."""


@dataclass(frozen=True)
class RepairPlan:
    """One node's bandwidth-optimal repair recipe.

    `reads` lists (helper shard index, tuple of sub-shard indices) in
    ascending helper order; the helper reads ONLY those sub-shards
    (each sub-shard is shard_len/alpha bytes). `matrix` maps the
    gathered symbols — concatenated in `reads` order — to the lost
    node's alpha sub-shards: lost = matrix @gf gathered.
    """

    target: int
    alpha: int
    beta: int  # nominal β: exact per-helper read on the clay arm (α/q);
    # piggyback group-helpers may read up to α (both halves)
    reads: tuple  # ((helper, (sub, ...)), ...)
    matrix: np.ndarray  # [alpha, sum(len(subs))], read-only

    @property
    def total_symbols(self) -> int:
        return sum(len(subs) for _, subs in self.reads)


@dataclass(frozen=True)
class _Geometry:
    arm: str  # "clay" | "piggyback"
    k: int
    m: int
    alpha: int
    beta: int
    gamma: int  # coupling coefficient (0 for piggyback)
    full: np.ndarray  # [(k+m)·alpha, k·alpha], top block identity
    parity: np.ndarray  # [m·alpha, k·alpha] contiguous slice of `full`
    plans: dict  # target -> RepairPlan (piggyback: data targets only)
    read_fraction: float  # mean bytes read per byte healed over targets


# --------------------------------------------------------------------------
# GF(2^8) linear-system solvers (vectorized row operations — gf.gf_mat_inv
# eliminates row-by-row in Python, too slow for the (n'·α)² systems here)


def _solve_square(mat: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Solve mat @gf X = rhs for square `mat` via Gauss-Jordan with
    whole-column vectorized elimination. Raises RegenGeometryError on a
    singular system."""
    n = mat.shape[0]
    if mat.shape != (n, n) or rhs.shape[0] != n:
        raise RegenGeometryError("solver shape mismatch")
    aug = np.concatenate(
        [np.asarray(mat, np.uint8), np.asarray(rhs, np.uint8)], axis=1
    )
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col] != 0))
        if aug[piv, col] == 0:
            raise RegenGeometryError("singular GF(2^8) system")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf.gf_mul(aug[col], gf.gf_inv(int(aug[col, col])))
        mask = aug[:, col] != 0
        mask[col] = False
        if mask.any():
            aug[mask] ^= gf.gf_mul(aug[mask, col][:, None],
                                   aug[col][None, :])
    return aug[:, n:]


def _solve_right(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve X @gf a = b (a: [r, c], b: [t, c]) — express each row of
    `b` as a combination of the rows of `a`. Free variables (redundant
    rows of `a`) are pinned to 0. Raises RegenGeometryError when some
    row of `b` is outside the row space of `a`."""
    at = np.asarray(a, np.uint8).T  # [c, r]: columns are a's rows
    bt = np.asarray(b, np.uint8).T  # [c, t]
    rows, nvars = at.shape
    aug = np.concatenate([at, bt], axis=1)
    piv_of_var: dict[int, int] = {}
    rank = 0
    for var in range(nvars):
        if rank >= rows:
            break
        piv = rank + int(np.argmax(aug[rank:, var] != 0))
        if aug[piv, var] == 0:
            continue
        if piv != rank:
            aug[[rank, piv]] = aug[[piv, rank]]
        aug[rank] = gf.gf_mul(aug[rank], gf.gf_inv(int(aug[rank, var])))
        mask = aug[:, var] != 0
        mask[rank] = False
        if mask.any():
            aug[mask] ^= gf.gf_mul(aug[mask, var][:, None],
                                   aug[rank][None, :])
        piv_of_var[var] = rank
        rank += 1
    if rank < rows and aug[rank:, nvars:].any():
        raise RegenGeometryError(
            "inconsistent GF(2^8) repair system (target outside the "
            "helpers' row space)"
        )
    x = np.zeros((bt.shape[1], nvars), dtype=np.uint8)
    for var, piv in piv_of_var.items():
        x[:, var] = aug[piv, nvars:]
    if not np.array_equal(gf.gf_matmul(x, a), np.asarray(b, np.uint8)):
        raise RegenGeometryError("repair solve verification failed")
    return x


def _node_rows(full: np.ndarray, alpha: int, nodes) -> np.ndarray:
    """Stack the generator rows of the given node indices."""
    return np.concatenate(
        [full[i * alpha:(i + 1) * alpha] for i in nodes], axis=0
    )


def _verify_mds(full: np.ndarray, k: int, n: int, alpha: int) -> None:
    """Every k-subset of node row-blocks must be invertible (the MDS
    property at sub-shard granularity — any k surviving shards decode).
    Exhaustive for small n-choose-k, deterministic sampling beyond."""
    import math

    total = math.comb(n, k)
    if total <= _MDS_EXHAUSTIVE_LIMIT:
        subsets = itertools.combinations(range(n), k)
    else:
        rng = np.random.default_rng(0x4D5352)  # "MSR"
        subsets = (
            tuple(sorted(rng.choice(n, size=k, replace=False)))
            for _ in range(_MDS_SAMPLES)
        )
    eye = np.eye(k * alpha, dtype=np.uint8)
    for subset in subsets:
        sub = _node_rows(full, alpha, subset)
        try:
            _solve_square(sub, eye[:, :0])  # invertibility only
        except RegenGeometryError as exc:
            raise RegenGeometryError(
                f"not MDS: survivor subset {subset} is singular"
            ) from exc


# --------------------------------------------------------------------------
# coupled-layer (Clay-style) arm


def _clay_params(k: int, m: int) -> tuple[int, int, int, int]:
    """(q, t, n_prime, alpha) for the coupled-layer grid, or raise."""
    n = k + m
    q = m
    if q < 2 or k < 2:
        raise RegenGeometryError("coupled-layer arm needs k >= 2, m >= 2")
    t = -(-n // q)  # ceil
    alpha = q ** t
    if alpha > _ALPHA_CAP:
        raise RegenGeometryError(
            f"sub-packetization q^t = {alpha} exceeds cap {_ALPHA_CAP}"
        )
    return q, t, q * t, alpha


def _clay_try_build(k: int, m: int, gamma: int) -> _Geometry:
    """Build + fully verify the coupled-layer geometry for one coupling
    coefficient; raises RegenGeometryError on any failed property."""
    n = k + m
    q, t, n_prime, alpha = _clay_params(k, m)
    beta = alpha // q
    if n_prime + m > 255:
        raise RegenGeometryError("grid too wide for the GF(2^8) Cauchy "
                                 "parity-check")
    planes = list(itertools.product(range(q), repeat=t))
    plane_idx = {z: zi for zi, z in enumerate(planes)}

    def coord(i: int) -> tuple[int, int]:
        return i % q, i // q

    def partner(i: int, z: tuple) -> tuple[int, int] | None:
        """(partner node, partner plane index) for a paired point, or
        None for unpaired points (x == z_y)."""
        x, y = coord(i)
        if z[y] == x:
            return None
        j = z[y] + y * q
        z2 = list(z)
        z2[y] = x
        return j, plane_idx[tuple(z2)]

    # Per-plane MDS parity-check over the UNCOUPLED symbols U: a Cauchy
    # matrix H[r][i] = 1/((n'+r) ^ i), full-rank on every m-column
    # subset, so each plane of U is an MDS codeword over the n' grid
    # nodes (real + virtual).
    h = np.zeros((m, n_prime), dtype=np.uint8)
    for r in range(m):
        for i in range(n_prime):
            h[r, i] = gf.gf_inv((n_prime + r) ^ i)

    # Unknowns: U(i; z) for all n' grid nodes × α planes, node-major.
    # Equations (square system, N = n'·α):
    #   m·α   parity rows   Σ_i H[r,i]·U(i;z) = 0            rhs 0
    #   k·α   data rows     C(j;z) = data[j,z]               rhs unit
    #   extra·α virtual rows C(v;z) = 0                      rhs 0
    # where C(i;z) = U(i;z)              (unpaired)
    #             = U(i;z) + γ·U(pair)   (paired, symmetric coupling).
    big_n = n_prime * alpha
    kx = k * alpha
    mat = np.zeros((big_n, big_n), dtype=np.uint8)
    rhs = np.zeros((big_n, kx), dtype=np.uint8)
    row = 0
    for zi in range(alpha):
        for r in range(m):
            for i in range(n_prime):
                mat[row, i * alpha + zi] = h[r, i]
            row += 1
    for i in range(n_prime):
        is_virtual = i >= n
        if not is_virtual and i >= k:
            continue  # real parity nodes carry no constraint row
        for zi, z in enumerate(planes):
            mat[row, i * alpha + zi] = 1
            p = partner(i, z)
            if p is not None:
                mat[row, p[0] * alpha + p[1]] ^= gamma
            if not is_virtual:
                rhs[row, i * alpha + zi] = 1
            row += 1
    if row != big_n:
        raise RegenGeometryError("construction system is not square")

    u_map = _solve_square(mat, rhs)  # U as a linear map of the data

    # On-disk symbols C for the n REAL nodes, from the coupling.
    full = np.zeros((n * alpha, kx), dtype=np.uint8)
    for i in range(n):
        for zi, z in enumerate(planes):
            c_row = u_map[i * alpha + zi].copy()
            p = partner(i, z)
            if p is not None:
                c_row ^= gf.gf_mul(gamma, u_map[p[0] * alpha + p[1]])
            full[i * alpha + zi] = c_row
    if not np.array_equal(full[:kx], np.eye(kx, dtype=np.uint8)):
        raise RegenGeometryError("systematic identity does not hold")

    plans = _clay_plans(full, k, m, q, alpha, beta, planes, coord)
    _verify_mds(full, k, n, alpha)
    full.setflags(write=False)
    # The coding matrix, built once per geometry (lru key).
    parity = np.ascontiguousarray(full[kx:])
    parity.setflags(write=False)
    ratio = float(np.mean([p.total_symbols / alpha for p in plans.values()]))
    return _Geometry(arm="clay", k=k, m=m, alpha=alpha, beta=beta,
                     gamma=gamma, full=full, parity=parity, plans=plans,
                     read_fraction=ratio)


def _clay_plans(full, k, m, q, alpha, beta, planes, coord) -> dict:
    """Solve every real node's repair matrix: helpers contribute their
    C symbols in the β repair planes {z : z_{y0} = x0} — pure selection
    reads. Virtual grid nodes hold zeros and cost nothing."""
    n = k + m
    plans = {}
    for f in range(n):
        x0, y0 = coord(f)
        subs = tuple(zi for zi, z in enumerate(planes) if z[y0] == x0)
        if len(subs) != beta:
            raise RegenGeometryError("repair plane count != beta")
        reads = tuple((hh, subs) for hh in range(n) if hh != f)
        a = np.concatenate(
            [full[hh * alpha + np.array(subs)] for hh, _ in reads], axis=0
        )
        b = full[f * alpha:(f + 1) * alpha]
        mtx = _solve_right(a, b)
        mtx.setflags(write=False)
        plans[f] = RepairPlan(target=f, alpha=alpha, beta=beta,
                              reads=reads, matrix=mtx)
    return plans


# --------------------------------------------------------------------------
# piggyback arm (high-rate geometries)


def _piggyback_build(k: int, m: int) -> _Geometry:
    """α=2 piggybacked RS: sub-stripe u is a clean RS codeword on the
    a-halves; sub-stripe v carries RS on the b-halves plus, on parities
    1..m-1, the XOR of one group of a-halves. Data-node repair reads
    k-1 b-halves + two v-parities + the group's other a-halves —
    (k + |group|)/2 shards instead of k. Parity repair stays dense
    (repair_plan returns None; the heal path falls back)."""
    if m < 2 or k < 2:
        raise RegenGeometryError("piggyback arm needs k >= 2, m >= 2")
    n = k + m
    alpha, beta = 2, 1
    base = cauchy.cauchy_parity_matrix(k, m)  # (m, k) MDS rows
    groups = [list(g) for g in np.array_split(np.arange(k), m - 1)]
    kx = k * alpha
    full = np.zeros((n * alpha, kx), dtype=np.uint8)
    full[:kx] = np.eye(kx, dtype=np.uint8)
    for i in range(m):
        u_row, v_row = (k + i) * 2, (k + i) * 2 + 1
        for j in range(k):
            full[u_row, 2 * j] = base[i, j]
            full[v_row, 2 * j + 1] = base[i, j]
        if i >= 1:
            for j in groups[i - 1]:
                full[v_row, 2 * j] ^= 1

    plans = {}
    for f in range(k):
        g = next(gi for gi, grp in enumerate(groups) if f in grp)
        want: dict[int, set] = {}
        for l in range(k):
            if l != f:
                want.setdefault(l, set()).add(1)
        for l in groups[g]:
            if l != f:
                want.setdefault(l, set()).add(0)
        want.setdefault(k, set()).add(1)  # p_0 v-half (clean RS on b)
        want.setdefault(k + 1 + g, set()).add(1)  # piggybacked v-half
        reads = tuple((hh, tuple(sorted(s)))
                      for hh, s in sorted(want.items()))
        a = np.concatenate(
            [full[hh * alpha + np.array(subs)] for hh, subs in reads],
            axis=0,
        )
        b = full[f * alpha:(f + 1) * alpha]
        mtx = _solve_right(a, b)
        mtx.setflags(write=False)
        plans[f] = RepairPlan(target=f, alpha=alpha, beta=beta,
                              reads=reads, matrix=mtx)

    _verify_mds(full, k, n, alpha)
    full.setflags(write=False)
    # The coding matrix, built once per geometry (lru key).
    parity = np.ascontiguousarray(full[kx:])
    parity.setflags(write=False)
    # Declared read ratio: data targets read total_symbols/α shards;
    # parity targets fall back to the dense k-survivor path.
    per_target = [p.total_symbols / alpha for p in plans.values()]
    per_target += [float(k)] * m
    ratio = float(np.mean(per_target))
    return _Geometry(arm="piggyback", k=k, m=m, alpha=alpha, beta=beta,
                     gamma=0, full=full, parity=parity, plans=plans,
                     read_fraction=ratio)


# --------------------------------------------------------------------------
# public surface (the registry's CodecEntry hooks)


@functools.lru_cache(maxsize=32)
def _geometry(k: int, m: int) -> _Geometry:
    """Construct-and-verify, cached per geometry. Prefers the
    coupled-layer arm (β-optimal for EVERY node); geometries past the
    sub-packetization cap take the piggyback arm."""
    try:
        _clay_params(k, m)
        clay_fits = True
    except RegenGeometryError:
        clay_fits = False
    if clay_fits:
        last: Exception | None = None
        for gamma in _GAMMA_CANDIDATES:
            try:
                return _clay_try_build(k, m, gamma)
            except RegenGeometryError as exc:
                last = exc
        raise RegenGeometryError(
            f"no admissible coupling coefficient for {k}+{m}: {last}"
        )
    return _piggyback_build(k, m)


def geometry_ok(k: int, m: int) -> bool:
    try:
        _geometry(k, m)
        return True
    except (RegenGeometryError, ValueError, ZeroDivisionError):
        return False


def subshards(k: int, m: int) -> int:
    """Sub-packetization α: shards must be sized in multiples of α and
    every matrix from this module addresses sub-shards, not shards."""
    return _geometry(k, m).alpha


def coding_matrix(k: int, m: int) -> np.ndarray:
    """Expanded systematic generator [(k+m)·α, k·α] over sub-shards."""
    return _geometry(k, m).full


def parity_matrix(k: int, m: int) -> np.ndarray:
    """Expanded parity rows [m·α, k·α] over sub-shards."""
    return _geometry(k, m).parity


@functools.lru_cache(maxsize=256)
def _reconstruct_cached(k: int, m: int, present: tuple,
                        targets: tuple) -> np.ndarray:
    geo = _geometry(k, m)
    rows = list(present[:k])
    if len(rows) < k:
        raise ValueError("need at least dataShards present shards")
    a = _node_rows(geo.full, geo.alpha, rows)
    b = _node_rows(geo.full, geo.alpha, targets)
    try:
        out = _solve_right(a, b)
    except RegenGeometryError as exc:
        raise ValueError(str(exc)) from exc
    out.setflags(write=False)
    return out


def reconstruct_matrix(k: int, m: int, present, targets) -> np.ndarray:
    """[len(targets)·α, k·α] matrix rebuilding `targets` from the first
    k `present` shards — the dense k-survivor path degraded GETs and
    fallback heals ride (same contract as gf.reconstruct_matrix, at
    sub-shard granularity)."""
    return _reconstruct_cached(k, m, tuple(present), tuple(targets))


def repair_plan(k: int, m: int, target: int) -> RepairPlan | None:
    """The bandwidth-optimal repair recipe for one lost shard, or None
    when this arm has no β-plan for the target (piggyback parity
    shards) and the caller must use the dense path."""
    return _geometry(k, m).plans.get(target)


def repair_read_fraction(k: int, m: int) -> float:
    """Declared mean bytes READ per byte healed for a single-shard
    repair (dense RS would be k). Derived from the verified plans, so
    'declared' and 'measured' cannot drift."""
    return _geometry(k, m).read_fraction


def arm(k: int, m: int) -> str:
    """Which construction serves this geometry ("clay"/"piggyback")."""
    return _geometry(k, m).arm


def host_reference_encode(k: int, m: int, data: np.ndarray) -> np.ndarray:
    """Host-numpy oracle: encode k data shards [k, S] into the full
    [k+m, S] codeword via the pure-python reference matmul — the byte
    truth kernels and repair paths are property-tested against."""
    geo = _geometry(k, m)
    s = data.shape[-1]
    if s % geo.alpha:
        raise ValueError(f"shard length {s} not a multiple of alpha "
                         f"{geo.alpha}")
    subs = np.asarray(data, np.uint8).reshape(k * geo.alpha,
                                              s // geo.alpha)
    out = gf.gf_matmul_shards_ref(geo.full, subs)
    return out.reshape(k + m, s)
