"""On-device exact set algebra over (hi, lo)-encoded k-mer sets.

The reference uses std HashSet probes for membership (query.rs:90,
classify.rs:230-236) and intersection counting (compare.rs:58).  Here
they are sort-merge joins: the query stream is sorted by (hi, lo) -- or
arrives already sorted -- and then MERGED with the db set, which is
always sorted (ops/merge.py), instead of re-sorting the static db every
batch.

Run-membership detection tolerates the merge's unstable within-run
order: a query row is a member iff a db row exists anywhere in its run,
checked with a forward cummax (last db position >= my run head) OR'd
with a backward cummin (next db position <= my run end).  Query-order
restoration is one single-key sort of a (position << 1 | member) packed
key, or a compaction when the queries are sorted unique (the classify
case).

Validity is threaded through the join: a SENTINEL-masked invalid query
must never match even a genuine k-mer whose encoding equals SENTINEL
(T^32 at k=32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import SENTINEL

U32 = jnp.uint32


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _member_merged(q_planes, d_planes):
    """Merge the pre-sorted query planes (hi, lo, flag=1, extras...) with
    the db planes (hi, lo, flag=0 valid / 1 padding, extras...) and mark
    query rows whose run contains a valid db row.

    Returns (member, sflag, sextras) in merged order, sized
    len(q) + len(d).
    """
    from .merge import merge_sorted_planes

    merged = merge_sorted_planes(d_planes, q_planes)
    shi, slo, sflag = merged[:3]
    sextras = merged[3:]
    n = shi.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    prev_hi = jnp.concatenate([jnp.full((1,), SENTINEL, U32), shi[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), SENTINEL, U32), slo[:-1]])
    is_head = ((shi != prev_hi) | (slo != prev_lo)) | (idx == 0)

    is_db = sflag == 0
    last_db = jax.lax.cummax(jnp.where(is_db, idx, -1))
    head_pos = jax.lax.cummax(jnp.where(is_head, idx, -1))
    fwd = last_db >= head_pos
    next_db = jax.lax.cummin(jnp.where(is_db, idx, n), reverse=True)
    nh_incl = jax.lax.cummin(jnp.where(is_head, idx, n), reverse=True)
    next_head_after = jnp.concatenate([nh_incl[1:], jnp.full((1,), n, jnp.int32)])
    bwd = next_db < next_head_after
    member = (sflag == 1) & (fwd | bwd)
    return member, sflag, sextras


def _db_planes(db_hi, db_lo, db_valid, extra_fills, extra_dtypes):
    nd = db_hi.shape[0]
    dh = jnp.where(db_valid, db_hi, SENTINEL)
    dl = jnp.where(db_valid, db_lo, SENTINEL)
    dflag = jnp.where(db_valid, 0, 1).astype(U32)
    extras = [
        jnp.full((nd,), fill, dt) for fill, dt in zip(extra_fills, extra_dtypes)
    ]
    return [dh, dl, dflag, *extras]


def check_db_sorted(db_hi, db_lo, db_valid) -> None:
    """Host-side debug check of the membership precondition: the db must
    be sorted ascending (as a u64) in its valid region.  Enabled with
    ORION_KMER_DEBUG=1; raises ValueError on violation.

    The merge-join implementations below silently return wrong results
    for an unsorted db (the old pre-merge implementation sorted
    internally), so host entry points call this before shipping a db.
    """
    import os

    if os.environ.get("ORION_KMER_DEBUG", "0") != "1":
        return
    hi = np.asarray(db_hi, dtype=np.uint64)
    lo = np.asarray(db_lo, dtype=np.uint64)
    valid = np.asarray(db_valid, dtype=bool)
    v = ((hi << np.uint64(32)) | lo)[valid]
    if v.shape[0] > 1 and not np.all(v[1:] >= v[:-1]):
        raise ValueError(
            "membership precondition violated: db planes are not sorted "
            "ascending in the valid region"
        )


@jax.jit
def membership(q_hi, q_lo, q_valid, db_hi, db_lo, db_valid):
    """For each query element, is it present in the db set?

    PRECONDITION: db entries must be unique where db_valid and SORTED
    ascending (as u64) in the valid region -- count tables and DB dumps
    are; external callers with raw sets must sort first (the merge-join
    gives silently wrong answers otherwise; see check_db_sorted for the
    ORION_KMER_DEBUG=1 runtime check).  Invalid queries/db slots never
    match.  Returns bool[Nq] aligned with the query order.
    """
    nq = q_hi.shape[0]
    nd = db_hi.shape[0]
    total = _next_pow2(nq + nd)
    pad = total - nq - nd
    big = jnp.uint32(0xFFFFFFFF)
    qh = jnp.where(q_valid, q_hi, SENTINEL)
    ql = jnp.where(q_valid, q_lo, SENTINEL)
    # packed restore key: (pos << 1) later gains the member bit; invalid
    # queries keep their position so validity can be re-applied in order
    pos = jnp.arange(nq, dtype=jnp.uint32)
    qh = jnp.concatenate([qh, jnp.full((pad,), SENTINEL, U32)])
    ql = jnp.concatenate([ql, jnp.full((pad,), SENTINEL, U32)])
    pos = jnp.concatenate([pos, jnp.full((pad,), big, U32)])
    sq = jax.lax.sort((qh, ql, pos), num_keys=2)
    q_planes = [sq[0], sq[1], jnp.ones((nq + pad,), U32), sq[2]]
    d_planes = _db_planes(db_hi, db_lo, db_valid, (big,), (U32,))
    member, _, (spos,) = _member_merged(q_planes, d_planes)
    # restore: single-key sort of (pos << 1 | member); db/pad rows carry
    # pos = 2^32-1 and sort past every real (pos << 1) key
    key = jnp.where(
        spos == big, big, (spos << U32(1)) | member.astype(U32)
    )
    (skey,) = jax.lax.sort((key,), num_keys=1)
    return ((skey[:nq] & 1) == 1) & q_valid


@jax.jit
def membership_sorted(q_hi, q_lo, q_valid, db_hi, db_lo, db_valid):
    """Membership for queries that are SORTED UNIQUE with a valid prefix
    (the classify case: the input k-mer table).

    Returns bool[Nq] aligned with the query order.  The queries are
    already sorted, so the join is a pure merge and order restoration is
    one compaction.
    """
    from .merge import compact_left

    nq = q_hi.shape[0]
    nd = db_hi.shape[0]
    total = _next_pow2(nq + nd)
    pad = total - nq - nd
    qh = jnp.concatenate(
        [jnp.where(q_valid, q_hi, SENTINEL), jnp.full((pad,), SENTINEL, U32)]
    )
    ql = jnp.concatenate(
        [jnp.where(q_valid, q_lo, SENTINEL), jnp.full((pad,), SENTINEL, U32)]
    )
    is_real = jnp.concatenate(
        [jnp.ones((nq,), U32), jnp.zeros((pad,), U32)]
    )
    q_planes = [qh, ql, jnp.ones((nq + pad,), U32), is_real]
    d_planes = _db_planes(db_hi, db_lo, db_valid, (0,), (U32,))
    member, _, (sreal,) = _member_merged(q_planes, d_planes)
    # real queries appear in value order == their input order (sorted
    # unique input with a valid prefix; sentinel-masked tails sort last)
    (cmember,) = compact_left([member.astype(U32)], sreal == 1)
    return (cmember[:nq] == 1) & q_valid


def _pack_bits32(b):
    """bool[n] (n % 32 == 0) -> little-endian u32[n/32] bitmask."""
    n = b.shape[0]
    w = b.reshape(n // 32, 32).astype(U32)
    shifts = jnp.arange(32, dtype=U32)
    return (w << shifts).sum(axis=1, dtype=U32)


@jax.jit
def classify_join(q_hi, q_lo, q_valid, db_hi, db_lo, db_valid):
    """Batched classify join: ONE merge answers, for every query row,
    "is it in the db set?" (member_q) and, for every db row, "is it hit
    by at least one valid query row?" (member_db).

    Queries are the concatenated per-reference k-mer segments of a whole
    database (classify.rs:224-236 batched: the per-reference probe loop
    collapses into one device dispatch per DB); the db is the input
    count table (sorted unique in its valid region -- see
    check_db_sorted).  Queries need NOT be globally sorted: they are
    sorted here with a restore key.  Invalid rows on either side never
    match, including the SENTINEL == T^32 (k=32) collision.

    Returns (member_q u32[Nq/32], member_db u32[Nd/32]), little-endian
    bit-packed (Nq, Nd must be multiples of 32) -- 8x less host link
    traffic than bool arrays.
    """
    nq = q_hi.shape[0]
    nd = db_hi.shape[0]
    total = _next_pow2(nq + nd)
    pad = total - nq - nd
    big = jnp.uint32(0xFFFFFFFF)
    qh = jnp.where(q_valid, q_hi, SENTINEL)
    ql = jnp.where(q_valid, q_lo, SENTINEL)
    qpos = jnp.arange(nq, dtype=U32)
    qreal = q_valid.astype(U32)
    sq = jax.lax.sort((qh, ql, qpos, qreal), num_keys=2)
    q_planes = [
        jnp.concatenate([sq[0], jnp.full((pad,), SENTINEL, U32)]),
        jnp.concatenate([sq[1], jnp.full((pad,), SENTINEL, U32)]),
        jnp.full((nq + pad,), 1, U32),  # flag: not a valid db row
        jnp.concatenate([sq[2], jnp.full((pad,), big, U32)]),  # restore pos
        jnp.concatenate([sq[3], jnp.zeros((pad,), U32)]),  # valid query?
    ]
    d_planes = [
        jnp.where(db_valid, db_hi, SENTINEL),
        jnp.where(db_valid, db_lo, SENTINEL),
        jnp.where(db_valid, 0, 1).astype(U32),
        U32(nq) + jnp.arange(nd, dtype=U32),  # restore pos past queries
        jnp.zeros((nd,), U32),
    ]
    from .merge import merge_sorted_planes

    shi, slo, sflag, spos, sqreal = merge_sorted_planes(d_planes, q_planes)
    n = shi.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    prev_hi = jnp.concatenate([jnp.full((1,), SENTINEL, U32), shi[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), SENTINEL, U32), slo[:-1]])
    is_head = ((shi != prev_hi) | (slo != prev_lo)) | (idx == 0)
    head_pos = jax.lax.cummax(jnp.where(is_head, idx, -1))
    nh_incl = jax.lax.cummin(jnp.where(is_head, idx, n), reverse=True)
    next_head_after = jnp.concatenate([nh_incl[1:], jnp.full((1,), n, jnp.int32)])
    is_db = sflag == 0
    is_qv = sqreal == 1
    last_db = jax.lax.cummax(jnp.where(is_db, idx, -1))
    next_db = jax.lax.cummin(jnp.where(is_db, idx, n), reverse=True)
    last_qv = jax.lax.cummax(jnp.where(is_qv, idx, -1))
    next_qv = jax.lax.cummin(jnp.where(is_qv, idx, n), reverse=True)
    m_q = is_qv & ((last_db >= head_pos) | (next_db < next_head_after))
    m_db = is_db & ((last_qv >= head_pos) | (next_qv < next_head_after))
    member = (m_q | m_db).astype(U32)  # disjoint roles
    # restore: queries carry pos 0..nq-1, db rows nq..nq+nd-1, pads big
    _, smember = jax.lax.sort((spos, member), num_keys=1)
    return (
        _pack_bits32(smember[:nq] == 1),
        _pack_bits32(smember[nq : nq + nd] == 1),
    )


@jax.jit
def intersection_size(a_hi, a_lo, a_valid, b_hi, b_lo, b_valid):
    """|A intersect B| for two sorted-unique sets (compare.rs:58).

    PRECONDITION: each side must be sorted ascending (as u64) over its
    valid slots with invalid slots only in a trailing pad -- true for
    every caller (DB dumps and count tables are sorted-unique;
    engine.intersection_size_host pads tails).  Both operands being
    sorted, the join is ONE merge of the sides instead of a 2-key
    lax.sort of the concatenation.  Each value occurs at most once per
    side, so a value is shared iff an adjacent merged pair has side
    markers {A, B}.
    """
    from .merge import merge_sorted_planes

    ah = jnp.where(a_valid, a_hi, SENTINEL)
    al = jnp.where(a_valid, a_lo, SENTINEL)
    bh = jnp.where(b_valid, b_hi, SENTINEL)
    bl = jnp.where(b_valid, b_lo, SENTINEL)
    sa = jnp.where(a_valid, 0, 2).astype(U32)
    sb = jnp.where(b_valid, 1, 2).astype(U32)
    mh, ml, ms = merge_sorted_planes([ah, al, sa], [bh, bl, sb])
    eq = (mh[1:] == mh[:-1]) & (ml[1:] == ml[:-1])
    ab = eq & (ms[1:] + ms[:-1] == 1)  # exactly one A-valid + one B-valid
    return ab.astype(jnp.int32).sum()
