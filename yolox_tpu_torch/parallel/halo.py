"""Halo exchange for the serving meshes: the image height split over the
`space` ranks of a `ServingMesh` (`parallel/mesh.py`).

The JAX package shards H over the `space` axis and lets GSPMD insert halo
exchanges at the slab borders. The port runs one process a device, so
each `space` rank holds a row slab of every activation and the few ops
that read neighbouring rows get them here, explicitly:

- `SpaceExchange.spatial(x, ksize, stride, op)` runs `op` on the slab
  extended by `extension(ksize, stride)` rows on each side that has a
  neighbour (rows fetched from the ranks that hold them), then crops the
  output rows that saw the extended slab's own padding in place of a
  neighbour's rows. At the image's top and bottom nothing is added, so
  the op's own padding applies there: zeros for a conv, -inf for a max
  pool. The blocks find the exchange in the state their YoloxModule
  shares with them (`models/blocks.py::BlockState.exchange`) and call
  `op(x)` itself when there is none (no meshed call, or no `space`
  split), so the one-process path keeps its launches and its bits.
- `extension(k, stride)` is `stride * ceil(pad / stride)` for a conv's
  'same' padding (k - 1) // 2: a multiple of the stride, so the output
  rows keep their parity and the crop is `ext / stride` rows.
- Slab borders lie on multiples of `SLAB_STRIDE` (32) input pixels, the
  model's largest stride, so the borders of every pyramid level line up
  and 1x1 convs, BN, activations, upsampling and concatenation need no
  halo. `halo_moves` computes, on ints, which rows a rank sends and
  receives for one op at one level; a halo taller than a neighbour's
  slab (the SPP pools' 6 rows on one-row slabs at stride 32) reaches
  across several ranks.

Transport (`Transport`): under NCCL, device tensors go by
`batch_isend_irecv` and `all_gather_into_tensor`. gloo sends, receives
and gathers CPU tensors only, so CUDA tensors are staged through pinned
host memory explicitly, and a CPU tensor under NCCL raises: no path
falls back from one transport to the other. Every payload crosses as
bytes (`uint8` views), whatever its dtype.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from yolox_tpu_torch.ops.quant import QTensor

SLAB_STRIDE = 32

Slab = Tuple[int, int]


def row_slabs(height: int, n_space: int) -> Tuple[Slab, ...]:
    """The (start, stop) input rows of each of `n_space` ranks: `height`
    split on multiples of `SLAB_STRIDE`, as evenly as height / SLAB_STRIDE
    allows, the first ranks taking one more; the last ranks' slabs are
    empty where there are fewer such bands than ranks. One rank takes
    every row of any height."""
    if n_space == 1:
        return ((0, height),)
    if height % SLAB_STRIDE:
        raise ValueError(f"the image height {height} is not a multiple of "
                         f"{SLAB_STRIDE}, the model's largest stride: it "
                         "cannot be split over `space`")
    base, rem = divmod(height // SLAB_STRIDE, n_space)
    out, start = [], 0
    for s in range(n_space):
        stop = start + (base + (s < rem)) * SLAB_STRIDE
        out.append((start, stop))
        start = stop
    return tuple(out)


def extension(ksize: int, stride: int) -> int:
    """Rows added on each side for a k x k op of `stride` with 'same'
    padding (k - 1) // 2: the padding rounded up to a multiple of the
    stride."""
    pad = (ksize - 1) // 2
    return stride * -(-pad // stride)


class Moves(NamedTuple):
    """One op's halo at one level, in that level's rows: the extended
    slab [lo, hi), the pieces to receive (peer, start, stop) in row
    order, and the pieces of this rank's slab to send (peer, start,
    stop)."""

    lo: int
    hi: int
    recv: Tuple[Tuple[int, int, int], ...]
    send: Tuple[Tuple[int, int, int], ...]


def halo_moves(slabs: Sequence[Slab], index: int, level: int, ext: int
               ) -> Moves:
    """The moves of rank `index` (of the `space` ranks holding `slabs`,
    in input rows) for an op that needs `ext` rows on each side, at a
    level of stride `level`. Empty slabs take no part."""
    rows = [(a // level, b // level) for a, b in slabs]
    height = rows[-1][1]
    r0, r1 = rows[index]
    if r0 == r1:
        return Moves(r0, r1, (), ())
    lo, hi = max(0, r0 - ext), min(height, r1 + ext)
    recv, send = [], []
    for j, (a, b) in enumerate(rows):
        if j == index or a == b:
            continue
        for s0, s1 in ((lo, r0), (r1, hi)):
            if max(s0, a) < min(s1, b):
                recv.append((j, max(s0, a), min(s1, b)))
        for s0, s1 in ((max(0, a - ext), a), (b, min(height, b + ext))):
            if max(s0, r0) < min(s1, r1):
                send.append((j, max(s0, r0), min(s1, r1)))
    return Moves(lo, hi, tuple(recv), tuple(send))


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _layout(t: torch.Tensor):
    """channels_last where `t` is stored so (and not also contiguous)."""
    if t.dim() == 4 and not t.is_contiguous() and \
            t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class Transport:
    """Point-to-point pieces and gathers of byte payloads over one group,
    by its backend (see the module docstring). `stats` counts what this
    rank sent: exchanges, their bytes and host seconds, gathers and
    theirs."""

    def __init__(self, group, backend: str):
        self.group, self.backend = group, backend
        self.stats = dict.fromkeys(
            ("exchanges", "exchange_bytes", "exchange_s", "gathers",
             "gather_bytes", "gather_s"), 0)

    def _staged(self, device: torch.device) -> bool:
        if self.backend == "nccl":
            if device.type != "cuda":
                raise ValueError(f"an NCCL serving mesh moves CUDA tensors, "
                                 f"not {device} ones")
            return False
        if self.backend != "gloo":
            raise ValueError(f"serving meshes run on NCCL or gloo, not "
                             f"{self.backend}")
        return device.type == "cuda"

    @staticmethod
    def _to_host(payloads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Pinned host copies of device byte payloads, complete on return."""
        out = []
        for p in payloads:
            h = torch.empty(p.numel(), dtype=torch.uint8, pin_memory=True)
            out.append(h.copy_(p, non_blocking=True))
        if payloads:
            torch.cuda.current_stream(payloads[0].device).synchronize()
        return out

    def exchange(self, sends, recvs, device) -> List[torch.Tensor]:
        """Send each (global rank, byte payload) of `sends` and receive each
        (global rank, n bytes) of `recvs`; returns the received payloads
        on `device`, in `recvs`' order."""
        staged = self._staged(device)
        t0 = time.perf_counter()
        payloads = [p for _, p in sends]
        if staged:
            payloads = self._to_host(payloads)
        bufs = [torch.empty(n, dtype=torch.uint8, pin_memory=staged,
                            device="cpu" if staged else device)
                for _, n in recvs]
        ops = [dist.P2POp(dist.isend, p, peer, group=self.group)
               for (peer, _), p in zip(sends, payloads)]
        ops += [dist.P2POp(dist.irecv, b, peer, group=self.group)
                for (peer, _), b in zip(recvs, bufs)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if staged:
            bufs = [b.to(device, non_blocking=True) for b in bufs]
        self.stats["exchanges"] += 1
        self.stats["exchange_bytes"] += sum(p.numel() for p in payloads)
        self.stats["exchange_s"] += time.perf_counter() - t0
        return bufs

    def all_gather(self, payload: torch.Tensor, size: int) -> torch.Tensor:
        """Every rank's byte payload (`size` bytes each; shorter ones are
        zero-padded to it), as a (ranks, size) uint8 tensor on the
        payload's device."""
        device = payload.device
        staged = self._staged(device)
        t0 = time.perf_counter()
        n = dist.get_world_size(self.group)
        padded = torch.zeros(size, dtype=torch.uint8, device=device)
        padded[:payload.numel()] = payload
        if self.backend == "nccl":
            out = torch.empty((n, size), dtype=torch.uint8, device=device)
            dist.all_gather_into_tensor(out, padded, group=self.group)
        else:
            if staged:
                padded = self._to_host([padded])[0]
            parts = [torch.empty(size, dtype=torch.uint8) for _ in range(n)]
            dist.all_gather(parts, padded, group=self.group)
            out = torch.stack(parts).to(device)
        self.stats["gathers"] += 1
        self.stats["gather_bytes"] += size
        self.stats["gather_s"] += time.perf_counter() - t0
        return out


class SpaceExchange:
    """The `space` split of one meshed call: every rank's slab (input
    rows), this rank's index among them, the group's global ranks and its
    `Transport`."""

    def __init__(self, slabs: Sequence[Slab], index: int,
                 peers: Sequence[int], transport: Transport):
        self.slabs, self.index = tuple(slabs), index
        self.peers, self.transport = tuple(peers), transport

    def level_of(self, rows: int) -> int:
        """The stride of the level at which this rank's slab has `rows`."""
        r0, r1 = self.slabs[self.index]
        if rows < 1 or (r1 - r0) % rows:
            raise ValueError(f"{rows} rows do not divide this rank's slab "
                             f"{(r0, r1)}")
        return (r1 - r0) // rows

    def extend(self, x: torch.Tensor, ext: int, axis: int):
        """x (this rank's slab along `axis`) with the rows of its
        neighbours within `ext` on each side: (extended, rows added
        above)."""
        level = self.level_of(x.shape[axis])
        r0 = self.slabs[self.index][0] // level
        mv = halo_moves(self.slabs, self.index, level, ext)
        sends = [(self.peers[j], as_bytes(x.narrow(axis, a - r0, b - a)))
                 for j, a, b in mv.send]
        piece = x.numel() // x.shape[axis] * x.element_size()
        recvs = [(self.peers[j], (b - a) * piece) for j, a, b in mv.recv]
        got = self.transport.exchange(sends, recvs, x.device)
        shape = list(x.shape)
        shape[axis] = mv.hi - mv.lo
        out = torch.empty(shape, dtype=x.dtype, device=x.device,
                          memory_format=_layout(x))
        out.narrow(axis, r0 - mv.lo, x.shape[axis]).copy_(x)
        for (j, a, b), buf in zip(mv.recv, got):
            part = list(x.shape)
            part[axis] = b - a
            out.narrow(axis, a - mv.lo, b - a).copy_(
                buf.view(x.dtype).view(part))
        return out, r0 - mv.lo

    def spatial(self, x, ksize: int, stride: int, op, axis: int = 2):
        """`op(x)` for a `ksize` x `ksize` op of `stride` with 'same'
        padding, x this rank's slab with rows along `axis` (a tensor or a
        QTensor): `op` runs on it extended by its neighbours' rows, and
        its output (a tensor, a QTensor or a list of them, NCHW) is
        cropped to the slab's rows."""
        codes = x.codes if isinstance(x, QTensor) else x
        rows = codes.shape[axis]
        extended, top = self.extend(codes, extension(ksize, stride), axis)
        if top % stride or rows % stride:
            raise ValueError(f"a slab of {rows} rows extended by {top} does "
                             f"not keep the parity of stride {stride}")
        y = op(x._replace(codes=extended) if isinstance(x, QTensor)
               else extended)
        return _crop(y, top // stride, rows // stride)

    def gather_rows(self, maps: Optional[Sequence[torch.Tensor]],
                    shapes: Sequence[Tuple[int, ...]], dtype, device
                    ) -> List[torch.Tensor]:
        """Whole-image maps from every rank's row slabs of them, in row
        order. `maps`: this rank's (B, C, h, W) slab of each map, None on
        a rank with an empty slab; `shapes`: each map's whole-image
        shape (every rank knows them), `dtype` and `device` theirs."""
        height = self.slabs[-1][1]
        rows = [[(b - a) * s[2] // height for s in shapes]
                for a, b in self.slabs]
        sizes = [sum(r * s[0] * s[1] * s[3] for r, s in zip(rs, shapes))
                 for rs in rows]
        esize = torch.empty((), dtype=dtype).element_size()
        if maps is None:
            payload = torch.empty(0, dtype=torch.uint8, device=device)
        else:
            for m, r, s in zip(maps, rows[self.index], shapes):
                if m.dtype != dtype or tuple(m.shape) != (s[0], s[1], r,
                                                          s[3]):
                    raise ValueError(f"a slab map {m.dtype} "
                                     f"{tuple(m.shape)} is not the planned "
                                     f"{dtype} {(s[0], s[1], r, s[3])}")
            payload = torch.cat([as_bytes(m) for m in maps])
        got = self.transport.all_gather(payload, max(sizes) * esize)
        out = [[] for _ in shapes]
        for i, rs in enumerate(rows):
            flat = got[i, :sizes[i] * esize].view(dtype)
            offset = 0
            for k, (r, s) in enumerate(zip(rs, shapes)):
                n = s[0] * s[1] * r * s[3]
                out[k].append(flat[offset:offset + n].view(s[0], s[1], r,
                                                           s[3]))
                offset += n
        return [torch.cat(parts, dim=2) for parts in out]


def _crop(t, start: int, n: int):
    """Rows [start, start + n) of an NCHW tensor, QTensor or list."""
    if isinstance(t, QTensor):
        return t._replace(codes=_crop(t.codes, start, n))
    if isinstance(t, (list, tuple)):
        return type(t)(_crop(u, start, n) for u in t)
    if start == 0 and n == t.shape[2]:
        return t
    return t.narrow(2, start, n).contiguous(memory_format=_layout(t))
