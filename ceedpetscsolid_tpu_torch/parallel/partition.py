"""Mesh partitioning for rank-per-subdomain execution (a copy of ceedpetscsolid_tpu/parallel/partition.py).

The DMPlexDistribute + PetscSF equivalent (reference src/setupdm.c:57-64 and
matops.c:33/57), redesigned TPU-first: all exchange patterns are computed at
setup into static, padded index arrays that compile into the jitted step as
all_to_all collectives — no host round-trips, deterministic owner ordering.

Scheme (per FE space / multigrid level, same element partition for all
levels as in the reference):
  * elements are block-partitioned into ndev contiguous chunks, padded to a
    uniform count; padded elements reference a dedicated trash node and
    carry zero qdata, so they contribute nothing;
  * every node is OWNED by the lowest-id shard whose elements touch it;
  * each shard's LOCAL node space is [owned nodes | ghost nodes | trash],
    padded uniformly;
  * the (owner -> ghost-holder) pair lists drive both directions:
      gather (G2L): owner sends owned values, holder writes ghost slots
      owner-sum (L2G-add): holder sends ghost contributions, owner adds
    (the INSERT / ADD_VALUES modes of DMGlobalToLocal / DMLocalToGlobal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SpacePartition:
    """Static partition data for one FE space over ndev shards.

    Shapes (all numpy, converted to device arrays by the distributed ops):
      conn_local        (ndev, nelem_max, P3)  int32  local-node indices
      elem_valid        (ndev, nelem_max)      bool
      owned_global_ids  (ndev, n_owned_max)    int64  (-1 padding)
      owned_valid       (ndev, n_owned_max)    bool
      pair_owned_slot   (ndev, ndev, m)  int32  [owner, holder] owned slots
      pair_ghost_slot   (ndev, ndev, m)  int32  [owner, holder] ghost slots
      pair_valid        (ndev, ndev, m)   bool
      ghost_by_holder_* : the same pair arrays transposed to [holder, owner]
    """

    ndev: int
    num_nodes_global: int
    nelem_max: int
    n_owned_max: int
    n_local: int            # owned_max + ghost_max + 1 (trash)
    n_elem_int: int         # leading INTERIOR elements on every shard
    conn_local: np.ndarray
    elem_valid: np.ndarray
    elem_gid: np.ndarray    # (ndev, nelem_max) global element ids, -1 pad
    owned_global_ids: np.ndarray
    owned_valid: np.ndarray
    # indexed [owner, holder]
    pair_owned_slot: np.ndarray
    pair_valid_owner: np.ndarray
    # indexed [holder, owner]
    pair_ghost_slot: np.ndarray
    pair_valid_holder: np.ndarray

    @property
    def trash_slot(self) -> int:
        return self.n_local - 1

    def halo_stats(self) -> dict:
        """Ghost-exchange volume per shard (partition quality metric)."""
        ghosts = self.pair_valid_holder.sum(axis=(1, 2))      # per holder
        return {
            "ghosts_per_shard": ghosts.tolist(),
            "total_ghosts": int(ghosts.sum()),
            "max_ghosts": int(ghosts.max()),
            "owned_per_shard": self.owned_valid.sum(axis=1).tolist(),
        }


def partition_space(conn: np.ndarray, num_nodes: int, ndev: int,
                    elem_gid: np.ndarray | None = None) -> SpacePartition:
    """Partition elements into ndev blocks and build exchange maps.

    conn: (nelem, P3) global element connectivity of the space.

    Within each shard, elements are reordered INTERIOR-FIRST (an element is
    interior when every node it touches is owned by its own shard), and
    ``n_elem_int`` records the largest k such that elements [0, k) are
    interior on EVERY shard. The distributed operator pipelines use this
    static split to compute interior elements while the ghost all_to_all is
    in flight (halo/compute overlap — the design target SURVEY §5 names for
    the PetscSF-equivalent exchange).

    elem_gid: optional (ndev, nelem_max) element order of another FE space
    over the SAME mesh (-1 padding). Passing the fine level's order to the
    coarser p-multigrid levels keeps element-indexed data (qdata, gradu
    stash) aligned across levels. An element whose fine-space nodes are all
    owned by shard s touches only entities whose incident elements all live
    on s, so it is interior at every level: the shared order preserves
    interior-first at each level (n_elem_int is recomputed per level as the
    leading interior run).
    """
    nelem, P3 = conn.shape
    if elem_gid is None:
        nelem_max = -(-nelem // ndev)
        elem_ids = [np.arange(s * nelem_max, min((s + 1) * nelem_max, nelem))
                    for s in range(ndev)]
    else:
        nelem_max = elem_gid.shape[1]
        elem_ids = [elem_gid[s][elem_gid[s] >= 0] for s in range(ndev)]

    # --- node ownership: lowest shard id touching the node ---------------
    owner = np.full(num_nodes, ndev, dtype=np.int32)
    for s in range(ndev - 1, -1, -1):
        nodes_s = conn[elem_ids[s]].ravel()
        owner[nodes_s] = s
    assert owner.max() < ndev, "unreferenced nodes in space"

    # --- interior-first element order + common static split --------------
    leads = []
    for s in range(ndev):
        ids = elem_ids[s]
        interior = (owner[conn[ids]] == s).all(axis=1)
        if elem_gid is None:
            perm = np.argsort(~interior, kind="stable")
            elem_ids[s] = ids[perm]
            leads.append(int(interior.sum()))
        else:                       # imposed order: leading interior run
            nonint = np.where(~interior)[0]
            leads.append(int(nonint[0]) if len(nonint) else len(ids))
    n_elem_int = min(leads) if leads else 0

    # --- per-shard local node sets ---------------------------------------
    owned_lists = [np.where(owner == s)[0] for s in range(ndev)]
    touched = [np.unique(conn[elem_ids[s]].ravel()) for s in range(ndev)]
    ghost_lists = [t[owner[t] != s] for s, t in enumerate(touched)]

    n_owned_max = max(len(o) for o in owned_lists)
    n_ghost_max = max((len(g) for g in ghost_lists), default=0)
    n_local = n_owned_max + n_ghost_max + 1
    trash = n_local - 1

    # global node -> (shard, owned slot)
    owned_slot_of = np.full(num_nodes, -1, dtype=np.int64)
    for s, o in enumerate(owned_lists):
        owned_slot_of[o] = np.arange(len(o))

    # per-shard local index of every global node it touches
    local_index = [dict() for _ in range(ndev)]
    for s in range(ndev):
        for i, n in enumerate(owned_lists[s]):
            local_index[s][n] = i
        for i, n in enumerate(ghost_lists[s]):
            local_index[s][n] = n_owned_max + i

    # --- local connectivity ----------------------------------------------
    conn_local = np.full((ndev, nelem_max, P3), trash, dtype=np.int32)
    elem_valid = np.zeros((ndev, nelem_max), dtype=bool)
    for s in range(ndev):
        ids = elem_ids[s]
        elem_valid[s, : len(ids)] = True
        li = local_index[s]
        block = conn[ids]
        # vectorized map via temporary lookup array
        lut = np.full(num_nodes, trash, dtype=np.int32)
        if li:
            keys = np.fromiter(li.keys(), dtype=np.int64, count=len(li))
            vals = np.fromiter(li.values(), dtype=np.int32, count=len(li))
            lut[keys] = vals
        conn_local[s, : len(ids)] = lut[block]

    # --- owned global ids -------------------------------------------------
    owned_global_ids = np.full((ndev, n_owned_max), -1, dtype=np.int64)
    owned_valid = np.zeros((ndev, n_owned_max), dtype=bool)
    for s, o in enumerate(owned_lists):
        owned_global_ids[s, : len(o)] = o
        owned_valid[s, : len(o)] = True

    # --- exchange pairs (owner -> holder) ---------------------------------
    pair_nodes = [[None] * ndev for _ in range(ndev)]
    m = 1
    for s in range(ndev):           # s = ghost holder
        g = ghost_lists[s]
        if len(g) == 0:
            continue
        for t in np.unique(owner[g]):   # t = owner
            nodes = g[owner[g] == t]
            pair_nodes[t][s] = nodes
            m = max(m, len(nodes))

    pair_owned_slot = np.zeros((ndev, ndev, m), dtype=np.int32)
    pair_valid = np.zeros((ndev, ndev, m), dtype=bool)
    pair_ghost_slot = np.full((ndev, ndev, m), trash, dtype=np.int32)
    for t in range(ndev):
        for s in range(ndev):
            nodes = pair_nodes[t][s]
            if nodes is None:
                continue
            k = len(nodes)
            pair_owned_slot[t, s, :k] = owned_slot_of[nodes]
            pair_ghost_slot[t, s, :k] = [local_index[s][n] for n in nodes]
            pair_valid[t, s, :k] = True

    elem_gid_out = np.full((ndev, nelem_max), -1, dtype=np.int64)
    for s, ids in enumerate(elem_ids):
        elem_gid_out[s, : len(ids)] = ids

    return SpacePartition(
        ndev=ndev,
        num_nodes_global=num_nodes,
        nelem_max=nelem_max,
        n_owned_max=n_owned_max,
        n_local=n_local,
        n_elem_int=n_elem_int,
        conn_local=conn_local,
        elem_valid=elem_valid,
        elem_gid=elem_gid_out,
        owned_global_ids=owned_global_ids,
        owned_valid=owned_valid,
        pair_owned_slot=pair_owned_slot,
        pair_valid_owner=pair_valid,
        pair_ghost_slot=np.swapaxes(pair_ghost_slot, 0, 1).copy(),
        pair_valid_holder=np.swapaxes(pair_valid, 0, 1).copy(),
    )


def scatter_global_to_owned(part: SpacePartition, u_cm: np.ndarray) -> np.ndarray:
    """(c, num_nodes) -> (ndev, c, n_owned_max), zero padding (component-major)."""
    c = u_cm.shape[0]
    out = np.zeros((part.ndev, c, part.n_owned_max), dtype=u_cm.dtype)
    ids = part.owned_global_ids
    valid = part.owned_valid
    for s in range(part.ndev):
        out[s][:, valid[s]] = u_cm[:, ids[s][valid[s]]]
    return out


def gather_owned_to_global(part: SpacePartition, owned: np.ndarray) -> np.ndarray:
    """(ndev, c, n_owned_max) -> (c, num_nodes)."""
    c = owned.shape[1]
    out = np.zeros((c, part.num_nodes_global), dtype=owned.dtype)
    valid = part.owned_valid
    for s in range(part.ndev):
        out[:, part.owned_global_ids[s][valid[s]]] = owned[s][:, valid[s]]
    return out
