"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its CUDA kernel computes, with the
same lane axis and dtypes.  The CPU path of ``kernels.ops`` runs them,
the CPU tests hold them bit-equal to the JAX reference, and
``chip_smoke.py`` holds each kernel bit-equal to them on the card.
"""
from __future__ import annotations

import torch

INF = 1.0000000150474662e30        # float32(1e30), the engine's idle time


def megastep_ref(read_bits: torch.Tensor, write_bits: torch.Tensor,
                 dirty_bits: torch.Tensor, item: torch.Tensor,
                 is_write: torch.Tensor, active: torch.Tensor,
                 ready: torch.Tensor, haslocks: torch.Tensor):
    """The cohort-step relations of every lane: ``(dep, ww, writers_at,
    readers_at, deg, lockhit, dirty_hit)``.

    Words are ``int32[L, n, W]``, ``item`` is ``int32[L, n]`` and the
    flags are ``bool[L, n]``.  ``dep``/``ww``/``writers_at``/
    ``readers_at`` are ``bool[L, n, n]``, ``deg`` is ``int32[L, n]`` and
    ``lockhit``/``dirty_hit`` are ``bool[L, n]`` — the counterpart of
    ``repro.kernels.ref.megastep_ref`` with a lane axis."""
    n = read_bits.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=read_bits.device)
    w_idx, b_idx = item >> 5, item & 31
    gather_idx = w_idx[:, :, None].expand(read_bits.shape[0], n, n)

    def table(bits):
        # [l, i, k] = bit item_i of row k
        cols = torch.gather(bits.transpose(1, 2), 1, gather_idx)
        return ((cols >> b_idx[:, :, None]) & 1).bool()

    writers_at = table(write_bits)
    readers_at = table(read_bits)
    others = torch.where(is_write[:, :, None], readers_at, writers_at)
    party = (others & active[:, None, :] & ~eye) | eye
    dep = (party[:, :, None, :] & party[:, None, :, :]).any(-1)
    same_item = item[:, :, None] == item[:, None, :]
    either_w = is_write[:, :, None] | is_write[:, None, :]
    dep = (dep | (same_item & either_w)) & ~eye
    deg = (dep & ready[:, None, :]).sum(2, dtype=torch.int32)
    ww = ((write_bits[:, :, None, :] & write_bits[:, None, :, :]) != 0
          ).any(-1) & ~eye
    lockhit = (ww & haslocks[:, None, :]).any(2)
    dirty_hit = ((read_bits & dirty_bits) != 0).any(-1)
    return dep, ww, writers_at, readers_at, deg, lockhit, dirty_hit


def reserve_cohort_ref(cpu_free: torch.Tensor, disk_free: torch.Tensor,
                       t_req: torch.Tensor, cpu_dur: torch.Tensor,
                       io_dur: torch.Tensor, cpu_m: torch.Tensor,
                       disk_m: torch.Tensor):
    """FCFS multi-reservation for every lane's cohort: walk the slots in
    index order; a masked slot takes the first ``argmin`` server of its
    pool, starting at ``max(t_req, free_at)``.  Returns ``(cpu_free',
    disk_free', cpu_done[L, n], disk_done[L, n])`` with ``INF`` where a
    slot made no request — ``repro.core.jaxsim._reserve_cohort`` with a
    lane axis."""
    cpu = cpu_free.clone()
    disk = disk_free.clone()
    lanes = torch.arange(cpu.shape[0], device=cpu.device)
    inf = torch.full((), INF, dtype=torch.float32, device=cpu.device)
    cpu_done, disk_done = [], []
    for i in range(t_req.shape[1]):
        t = t_req[:, i]
        ci = cpu.argmin(1)
        cdone = torch.maximum(t, cpu[lanes, ci]) + cpu_dur[:, i]
        cm = cpu_m[:, i]
        cpu[lanes, ci] = torch.where(cm, cdone, cpu[lanes, ci])
        di = disk.argmin(1)
        ddone = torch.maximum(t, disk[lanes, di]) + io_dur[:, i]
        dm = disk_m[:, i]
        disk[lanes, di] = torch.where(dm, ddone, disk[lanes, di])
        cpu_done.append(torch.where(cm, cdone, inf))
        disk_done.append(torch.where(dm, ddone, inf))
    return cpu, disk, torch.stack(cpu_done, 1), torch.stack(disk_done, 1)


def occ_validate_ref(commit_pre: torch.Tensor, read_bits: torch.Tensor,
                     dirty_bits: torch.Tensor, write_bits: torch.Tensor
                     ) -> torch.Tensor:
    """OCC same-iteration validation: walk the slots in index order; a
    would-be committer fails when its read row meets its dirty row or
    the write rows of the lower committers that survived.  Returns
    ``bool[L, n]`` failures — the ``occ_validate_multi`` scan of
    ``repro.core.jaxsim._cohort_body`` with a lane axis."""
    acc = torch.zeros_like(read_bits[:, 0])
    fails = []
    for i in range(read_bits.shape[1]):
        c = commit_pre[:, i]
        fail = c & ((read_bits[:, i] & (dirty_bits[:, i] | acc)) != 0
                    ).any(-1)
        acc = acc | torch.where((c & ~fail)[:, None], write_bits[:, i], 0)
        fails.append(fail)
    return torch.stack(fails, 1)
