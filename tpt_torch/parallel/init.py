"""Process-group bootstrap for sharded rendering (port of tpt.parallel.init).

JAX runs one controller over every device; ``torch.distributed`` runs one
process per rank.  This module joins a process to its job and lays out the
('dp', 'sp') mesh host-aware:

  * :func:`init_distributed` wraps ``torch.distributed.init_process_group``
    with the JAX package's fail-fast checks, so every rank joins the same job
    and the hosts are homogeneous before any mesh is built;
  * :func:`make_host_mesh` puts the ``dp`` (pixel-band) axis across hosts and
    keeps the ``sp`` (sample-group) axis inside a host, so the O(H*W/dp)
    sum over ``sp`` stays on the host's links and only the scalar ray count
    and the material gradients cross hosts.

Run recipe (N hosts under ``torchrun``, which sets RANK, WORLD_SIZE and
LOCAL_WORLD_SIZE):

    from tpt_torch.parallel import init_distributed, make_host_mesh, make_dist_renderer
    init_distributed()                     # env:// rendezvous
    mesh = make_host_mesh(sp=1)            # dp = every rank, across hosts
    render = make_dist_renderer(mesh, cfg) # each rank renders its row band

A single process needs no rendezvous: with no arguments and no RANK or
WORLD_SIZE in the environment :func:`init_distributed` does nothing and
returns 1, and the sharded functions run on a 1x1 mesh whose collectives are
identities.  ``tpt_torch.parallel.launch`` starts local ranks for tests and
smoke runs.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> int:
    """Join (or create) the job.  Returns the world size.

    With no arguments the rendezvous is ``env://`` (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, as torchrun sets them); with none of those in
    the environment either, the process is a world of one and nothing is
    initialised.  Explicit arguments come together:

        init_distributed("tcp://10.0.0.1:8476", world_size=4, rank=r)

    ``backend`` defaults to NCCL when the process sees a CUDA device and
    gloo otherwise.  Fail-fast checks: the three arguments are all given or
    none; a second call with another topology raises; the world must divide
    into equal hosts of LOCAL_WORLD_SIZE ranks.
    """
    given = [a is not None for a in (init_method, world_size, rank)]
    if any(given) and not all(given):
        raise ValueError("explicit init needs init_method, world_size and rank together")
    explicit = all(given)
    if dist.is_initialized():
        if explicit and (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise RuntimeError(
                f"already initialised as rank {dist.get_rank()} of {dist.get_world_size()}, "
                f"asked for rank {rank} of {world_size}")
        _validate_topology()
        return dist.get_world_size()
    if not explicit and "WORLD_SIZE" not in os.environ and "RANK" not in os.environ:
        # a world of one: init_process_group("env://") would wait for a peer
        # that never comes
        _validate_topology()
        return 1
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if explicit:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    else:
        dist.init_process_group(backend, init_method="env://")
    _validate_topology()
    return dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_world_size() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE (torchrun's), else the world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def _validate_topology() -> None:
    n_global, n_local = world_size(), local_world_size()
    if n_local < 1 or n_global % n_local:
        raise RuntimeError(f"heterogeneous hosts: {n_global} ranks not divisible by "
                           f"{n_local} ranks a host")


def host_layout(sp: int = 1, ranks: Optional[Sequence[int]] = None,
                local_size: Optional[int] = None):
    """The (dp, sp) rank grid of :func:`make_host_mesh`, checked, as a list
    of rows.  Rank r lives on host r // ``local_size``, as torchrun numbers
    ranks host-major; rows of the grid are ``dp`` and its columns ``sp``, so
    every sp-group lies inside one host when ``sp`` divides the ranks a
    host."""
    explicit = ranks is not None
    ranks = [int(r) for r in ranks] if explicit else list(range(world_size()))
    local_size = local_size or local_world_size()
    n = len(ranks)
    if explicit:
        # group explicit lists by their owning host, not by division: a
        # hand-picked list of 3 ranks of host A and 1 of host B must not pass
        # the containment check below
        owners = Counter(r // local_size for r in ranks)
        per_host = min(owners.values())
        if len(set(owners.values())) > 1 and sp > 1:
            raise ValueError(f"explicit rank list is host-imbalanced {dict(owners)}; sp>1 "
                             "needs equal ranks a host so sample-group sums stay inside a host")
        n_hosts = len(owners)
    else:
        per_host = local_size
        n_hosts = max(n // local_size, 1)
    if sp <= 0 or n % sp:
        raise ValueError(f"sp={sp} must divide {n} ranks")
    if n_hosts > 1 and per_host % sp:
        raise ValueError(f"sp={sp} must divide the ranks a host ({per_host}) so sample-group "
                         "sums stay inside a host")
    return [ranks[i:i + sp] for i in range(0, n, sp)]


def make_host_mesh(sp: int = 1, ranks: Optional[Sequence[int]] = None,
                   local_size: Optional[int] = None):
    """('dp', 'sp') mesh with dp spanning hosts and sp inside a host
    (:func:`host_layout`).  ``ranks``: an explicit list, honoured as given
    (every rank of the world still calls this; ranks outside the list get
    a mesh they are not part of).  Single host: equals
    ``make_mesh(sp=sp)``."""
    from .dist import Mesh
    return Mesh.from_ranks(host_layout(sp, ranks, local_size))
