"""The sharded KinectFusion step over a ``torch.distributed`` mesh (port
of ``slambench_tpu/parallel/step.py``).

Every rank of the mesh (``parallel/mesh.py``) runs this step on its own
shard, as ``shard_map`` runs one program per device:

* **TSDF z-slabs** — ``tsdf`` / ``weight`` hold the rank's
  ``[slab_z, Y, X]`` planes; everything else is replicated. Integration
  fuses the replicated depth into the slab (``ops/integrate.py`` with
  ``z_offset`` / ``z_total``; with ``SLAMBENCH_INTEGRATE_BLOCKS``, over
  the slab's frustum-culled blocks): no communication.
* **Slab-composite raycast with halo exchange** — every rank marches the
  whole ray grid, but each ray only over the interval in which it
  crosses the rank's slab, entered one ``large_step`` early so a
  crossing on a slab boundary is caught; the ``halo`` planes on either
  side come from the neighbours (``Mesh.halo``). The march is the
  single-card min-mip march (``ops/raycast_fast.py``: ``make_skip_mip``,
  ``mip_march``, ``rescan_refine``) on a min-mip of the halo-extended
  slab. The first hit is a ``pmin`` across ranks, and the slab that owns
  it gives the normal through a masked ``psum``.
* **ICP on row blocks + psum** — each level's maps are padded to the
  mesh size in rows (INVALID normals in the padded rows) and each rank
  runs K2F (``ops/hopper/reduce.py:track_reduce_cuda``) on its block
  against the replicated reference maps; one 32-float ``psum`` an
  iteration completes the normal equations, and every rank solves the
  same 6x6 system, so the pose stays equal bit for bit on every rank
  (``compute_frame`` asserts it). The loop is ``KFusion._icp``'s: the
  whole budget with a freeze, census included.
* **Banded preprocessing** — mm->m is replicated; each rank filters its
  ``H/n`` rows with K1 (``ops/hopper/bilateral.py:bilateral_filter_cuda``)
  on a band cut with a ``RADIUS``-row apron whose out-of-image rows take
  the reference's uint-wrap clamp (negative -> H-1), and one
  ``all_gather`` replicates the filtered depth. At one rank, or when the
  rows do not divide, the replicated route runs (K1F).

The halo is each neighbour's adjacent planes: the rank before sends its
last ``halo`` planes and the rank after its first. (JAX's
``_halo_exchange`` permutes each slab's first planes forward and last
planes back, so a rank's halo there holds planes a slab away from its
own: ROADMAP.md §3.)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slambench_tpu_torch import params
from slambench_tpu_torch.geometry import (
    constant, get_camera_matrix, get_inverse_camera_matrix, length3,
    mat4mul, normalize3, rigid_inverse,
)
from slambench_tpu_torch.ops.hopper.bilateral import bilateral_filter_cuda
from slambench_tpu_torch.ops.integrate import integrate, integrate_blocks
from slambench_tpu_torch.ops.preprocess import mm2meters
from slambench_tpu_torch.ops.raycast import camera_rays, ray_box_clip
from slambench_tpu_torch.ops.raycast_fast import (
    MIP_BLOCK, make_min_mip, make_skip_mip, mip_march, rescan_refine,
)
from slambench_tpu_torch.ops.render import shade
from slambench_tpu_torch.parallel.mesh import Mesh
from slambench_tpu_torch.pipeline import KFusion, KFusionState
from slambench_tpu_torch.volume import grad, init_volume, interp


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ShardedKFusion(KFusion):
    """``KFusion`` on one rank of a mesh: the same phases and state
    leaves, with ``tsdf`` / ``weight`` this rank's z-slab. The phase
    methods run the sharded versions, so ``compute_frame``,
    ``scan_step`` (JAX's ``_scan_step``), ``process_frame`` and the
    batched routes are the parent's; the batched routes replay a CUDA
    graph only where the mesh's collectives can be captured (NCCL),
    else they loop."""

    def __init__(self, *args, mesh: Mesh, **kwargs):
        if "device" in kwargs and torch.device(kwargs["device"]) \
                != mesh.device:
            raise ValueError(f"device {kwargs['device']} is not the mesh "
                             f"rank's {mesh.device}")
        kwargs["device"] = mesh.device
        self.mesh = mesh
        self.axis = mesh.axis_name
        self.n_shards = mesh.size
        self.rank = mesh.rank
        super().__init__(*args, **kwargs)
        sx, sy, sz = self.volume_resolution
        if sz % self.n_shards:
            raise ValueError(
                f"volume z ({sz}) must divide by mesh size ({self.n_shards})")
        self.slab_z = sz // self.n_shards
        self.z0 = self.rank * self.slab_z          # first global plane
        # Halo: the back-extended march (one large_step) plus the
        # interp/grad support (2 voxels).
        vz = self.volume_dimensions[2] / sz
        self.halo = min(int(math.ceil(0.75 * self.mu / vz)) + 2, self.slab_z)
        # The slab raycast starts every ray cold (JAX's has no warm start).
        self.warm_start = False
        # The band's source rows, apron included (uint-wrap clamp).
        hb, r = self.H // self.n_shards, params.RADIUS
        rows = self.rank * hb + np.arange(-r, hb + r)
        rows = np.where(rows < 0, self.H - 1, np.minimum(rows, self.H - 1))
        self._band_rows = torch.from_numpy(rows).to(self.device)

    # ------------------------------------------------------------------ #

    def init_state(self) -> KFusionState:
        """Fresh state with this rank's slab; ``mip`` is the whole
        volume's initial min-mip, replicated and (as in JAX) left as it
        is by the sharded step."""
        sx, sy, sz = self.volume_resolution
        tsdf, weight = init_volume((sx, sy, self.slab_z), self.device)
        cells = tuple(-(-s // MIP_BLOCK) for s in (sz, sy, sx))
        mip = torch.full(cells, 32766, dtype=torch.int16, device=self.device)
        return self._fresh_state(tsdf, weight, mip)

    def full_state(self, state: KFusionState) -> KFusionState:
        """The whole-volume state on every rank (the slabs gathered, the
        min-mip rebuilt): what ``--checkpoint`` saves."""
        tsdf = self.mesh.all_gather_rows(state.tsdf, "state_all_gather")
        weight = self.mesh.all_gather_rows(state.weight, "state_all_gather")
        return dataclasses.replace(state, tsdf=tsdf, weight=weight,
                                   mip=make_min_mip(tsdf))

    def local_state(self, state: KFusionState) -> KFusionState:
        """A whole-volume state cut to this rank's slab (``--resume``)."""
        z = slice(self.z0, self.z0 + self.slab_z)
        return dataclasses.replace(state, tsdf=state.tsdf[z].contiguous(),
                                   weight=state.weight[z].contiguous())

    # ----------------------- per-rank building blocks ----------------- #

    def _halo_exchange(self, slab: torch.Tensor,
                       tag: str = "halo_ppermute") -> torch.Tensor:
        """``[slab_z, Y, X]`` extended by ``halo`` planes from each
        neighbour (plane ``k`` is global plane ``k + z0 - halo``)."""
        return self.mesh.halo(slab, self.halo, tag)

    def _slab_interp(self, ext: torch.Tensor, z0_ext: int,
                     pos: torch.Tensor) -> torch.Tensor:
        """Trilinear interp against the extended slab at world ``pos``."""
        return interp(ext, self.volume_dimensions, pos, z0_ext,
                      self.volume_resolution[2])

    def _slab_grad(self, ext: torch.Tensor, z0_ext: int,
                   pos: torch.Tensor) -> torch.Tensor:
        """Central-difference gradient against the extended slab."""
        return grad(ext, self.volume_dimensions, pos, z0_ext,
                    self.volume_resolution[2])

    def _slab_march(self, tsdf_slab: torch.Tensor, view: torch.Tensor,
                    far_plane: float, early_exit: bool, tags: tuple):
        """The slab-composited march: (t_hit [H, W], 0 for a miss; hit
        positions [3, H, W]; the owning slab's TSDF gradient there).
        ``tags`` name the halo, pmin and psum in the mesh's tally."""
        H, W = self.H, self.W
        sx, sy, sz = self.volume_resolution
        dim = self.volume_dimensions
        dev = self.device
        vz = dim[2] / sz
        z0_ext = self.z0 - self.halo
        large_step = 0.75 * self.mu
        m = MIP_BLOCK

        ext = self._halo_exchange(tsdf_slab, tags[0])
        ext_z = ext.shape[0]
        mip_local = make_min_mip(ext)
        mzb, myb, mxb = mip_local.shape
        flat_skip = make_skip_mip(mip_local).reshape(-1)
        flat_ext = ext.reshape(-1)

        origin, direction = camera_rays(view, (H, W))
        o = origin.reshape(3, 1, 1)
        tnear, tfar = ray_box_clip(origin, direction, dim, params.NEAR_PLANE,
                                   far_plane)
        # Ray x slab z-interval [z0*vz, (z0+slab_z)*vz) in float32, entered
        # one large_step early to catch boundary-spanning crossings.
        zlo = float(np.float32(self.z0) * np.float32(vz))
        zhi = float(np.float32(self.z0 + self.slab_z) * np.float32(vz))
        dz = torch.where(direction[2] == 0, 1e-20, direction[2])
        t1 = (zlo - origin[2]) / dz
        t2 = (zhi - origin[2]) / dz
        my_tnear = torch.maximum(tnear, torch.minimum(t1, t2) - large_step)
        my_tfar = torch.minimum(tfar, torch.maximum(t1, t2))

        voxel = constant((dim[0] / sx, dim[1] / sy, vz), torch.float32,
                         dev).reshape(3, 1, 1)
        limit = constant((sx - 1, sy - 1, sz - 1), torch.int32,
                         dev).reshape(3, 1, 1)
        vx_, vy_ = dim[0] / sx, dim[1] / sy
        cell = constant((m * vx_, m * vy_, m * vz), torch.float32,
                        dev).reshape(3, 1, 1)

        def local_idx(t):
            """Global-clamped voxel index, z localized to the ext slab."""
            pos = o + direction * t[None]
            gi = torch.clamp(torch.clamp((pos / voxel).to(torch.int32),
                                         min=0), max=limit)
            lz = torch.clamp(gi[2] - z0_ext, 0, ext_z - 1)
            return gi[0], gi[1], lz

        def sample_t(t):
            x, y, lz = local_idx(t)
            vflat = (lz.long() * sy + y) * sx + x
            bx = torch.clamp(x // m, 0, mxb - 1)
            by = torch.clamp(y // m, 0, myb - 1)
            bz = torch.clamp(lz // m, 0, mzb - 1)
            sflat = (bz.long() * myb + by) * mxb + bx
            return (flat_ext[vflat].to(torch.float32) * params.TSDF_INV_SCALE,
                    flat_skip[sflat].to(torch.int32))

        def dist_exit_t(t, d_val):
            """Exit of the guaranteed-empty ball of skip cells; z cells
            live on the ext-local grid (``z0_ext`` planes from 0)."""
            pos = o + direction * t[None]
            x, y, lz = local_idx(t)
            bx = (x // m).to(torch.float32)
            by = (y // m).to(torch.float32)
            bz = (lz // m).to(torch.float32)
            r = (d_val - 1).to(torch.float32)
            base = torch.stack([bx * (m * vx_), by * (m * vy_),
                                (bz * m + z0_ext) * vz])
            lo = base - r * cell
            hi = base + (r + 1.0) * cell
            dd = torch.where(direction == 0, 1e-20, direction)
            t_axis = torch.where(dd > 0, (hi - pos) / dd, (lo - pos) / dd)
            dt = torch.minimum(torch.minimum(t_axis[0], t_axis[1]),
                               t_axis[2])
            return t + torch.clamp(dt, min=0.0) + 0.25 * self.step

        def tri_t(t):
            return self._slab_interp(ext, z0_ext, o + direction * t[None])

        def tri_batch(ts):
            return self._slab_interp(ext, z0_ext, o.reshape(3, 1, 1, 1)
                                     + direction[:, None] * ts[None])

        budget = int((far_plane - params.NEAR_PLANE) / self.step) + 2
        out = mip_march(sample_t, dist_exit_t, my_tnear, my_tfar, self.step,
                        large_step, budget, early_exit)
        t_hit_local = rescan_refine(tri_t, tri_batch, out, self.step)

        # First hit across slabs.
        t_inf = torch.where(t_hit_local > 0, t_hit_local,
                            torch.full_like(t_hit_local, math.inf))
        t_min = self.mesh.pmin(t_inf, tags[1])
        t_hit = torch.where(torch.isfinite(t_min), t_min,
                            torch.zeros_like(t_min))
        hit_pos = o + direction * t_hit[None]
        hit = t_hit > 0

        # The owning slab (by hit z) contributes the gradient; the top
        # slab owns hits at or above its upper edge, the bottom below.
        hz = hit_pos[2]
        own = hit & (hz >= zlo) & (hz < zhi)
        if self.rank == self.n_shards - 1:
            own = own | (hit & (hz >= zhi))
        if self.rank == 0:
            own = own | (hit & (hz < zlo))
        g = self._slab_grad(ext, z0_ext, hit_pos)
        g = self.mesh.psum(torch.where(own[None], g, torch.zeros_like(g)),
                           tags[2])
        return t_hit, hit_pos, g

    def _slab_raycast(self, tsdf_slab: torch.Tensor, view: torch.Tensor,
                      early_exit: bool = True):
        """Replicated (vertex, normal) reference maps of the whole volume
        from this rank's slab (JAX's ``_slab_raycast``)."""
        t_hit, hit_pos, g = self._slab_march(
            tsdf_slab, view, params.FAR_PLANE, early_exit,
            ("halo_ppermute", "raycast_pmin", "raycast_psum_normal"))
        hit = t_hit > 0
        glen = length3(g)
        normal = normalize3(g)
        invalid = torch.zeros_like(normal)
        invalid[0] = params.INVALID
        normal = torch.where((hit & (glen != 0))[None], normal, invalid)
        vertex = torch.where(hit[None], hit_pos, torch.zeros_like(hit_pos))
        return vertex, normal

    # --------------------------- sharded phases ----------------------- #

    def preprocessing(self, state: KFusionState,
                      input_depth: torch.Tensor) -> KFusionState:
        return self._sharded_preprocessing(state, input_depth)

    def _sharded_preprocessing(self, state: KFusionState,
                               input_depth: torch.Tensor) -> KFusionState:
        """mm->m replicated, then K1 on this rank's band of output rows
        and one ``all_gather`` of the bands; the replicated K1F at one
        rank or when the rows do not divide."""
        n, H = self.n_shards, self.H
        if n == 1 or H % n:
            return KFusion.preprocessing(self, state, input_depth)
        r = params.RADIUS
        fd = mm2meters(input_depth, input_depth.shape[1] // self.W)
        band = bilateral_filter_cuda(fd[self._band_rows].contiguous(),
                                     self.gaussian, params.E_DELTA, r)[r:-r]
        sd0 = self.mesh.all_gather_rows(band, "preprocess_all_gather")
        return dataclasses.replace(state, float_depth=fd, scaled_depth0=sd0)

    def tracking(self, state: KFusionState, census: bool = False):
        return self._sharded_tracking(state, census)

    def _sharded_tracking(self, state: KFusionState, census: bool = False):
        """Coarse-to-fine ICP with every level's rows split over the
        mesh: K2F on this rank's block, one 32-float ``psum`` an
        iteration, level 0's result codes gathered back to H x W."""
        n = self.n_shards
        verts, norms = self._level_maps(state.scaled_depth0)
        vb, nb = [], []
        for v, nm in zip(verts, norms):
            _, h, w = v.shape
            hp = _round_up(h, n)
            if hp != h:
                # Padded rows carry INVALID normals: result -1, no sum.
                pad_v = torch.zeros((3, hp - h, w), dtype=v.dtype,
                                    device=v.device)
                pad_n = torch.zeros_like(pad_v)
                pad_n[0] = params.INVALID
                v = torch.cat([v, pad_v], dim=1)
                nm = torch.cat([nm, pad_n], dim=1)
            blk = slice(self.rank * (hp // n), (self.rank + 1) * (hp // n))
            vb.append(v[:, blk].contiguous())
            nb.append(nm[:, blk].contiguous())
        return self._icp(
            state, vb, nb, census,
            psum=lambda red: self.mesh.psum(red, "icp_psum"),
            gather_result=lambda res: self.mesh.all_gather_rows(
                res, "track_result_all_gather")[:self.H, :self.W])

    def _integrate_volume(self, state: KFusionState, pose: torch.Tensor,
                          gate):
        """Fuse the depth into this rank's slab (its planes' global z);
        as in JAX, no min-mip is kept: the slab raycast builds one of the
        halo-extended slab every frame. With a block grid, the slab's
        own frustum-culled blocks (JAX ``parallel/step.py:460-479``):
        ``max(1, NZ // ranks)`` z-blocks a slab, and the monolithic
        integrate where they do not divide the slab (JAX's rule) or on
        the gated route."""
        args = (state.tsdf, state.weight, state.float_depth,
                rigid_inverse(pose), get_camera_matrix(self._k), self.mu,
                params.MAX_WEIGHT, self.volume_dimensions)
        slab = dict(z_offset=self.z0, z_total=self.volume_resolution[2])
        bz, by, bx = self.integrate_block_grid
        bz = max(1, bz // self.n_shards)
        with self.timings.span("integrate", state.tsdf.numel()):
            if gate is None and (bz, by, bx) != (1, 1, 1) \
                    and not self.slab_z % bz:
                tsdf, weight = integrate_blocks(*args, n_z=bz, n_y=by,
                                                n_x=bx, **slab)
            else:
                tsdf, weight = integrate(*args, gate=gate, **slab)
        return tsdf, weight, state.mip

    def raycasting(self, state: KFusionState, *, early_exit: bool = True
                   ) -> KFusionState:
        """The slab-composite raycast from the current pose; the hit
        distances (``prev_t_hit``) are left as they are, as in JAX."""
        view = mat4mul(state.pose, get_inverse_camera_matrix(self._k))
        with self.timings.span("raycast", self.H * self.W):
            vertex, normal = self._slab_raycast(state.tsdf, view,
                                                early_exit)
        return dataclasses.replace(state, raycast_pose=state.pose,
                                   ref_vertex=vertex, ref_normal=normal)

    # --------------------------- frontend ----------------------------- #

    def compute_frame(self, state: KFusionState, input_depth: torch.Tensor,
                      **gates) -> KFusionState:
        state = super().compute_frame(state, input_depth, **gates)
        self.mesh.assert_replicated(state.pose, "the pose")
        return state

    def _scan(self, state: KFusionState, depths: torch.Tensor, gates: tuple):
        state, outs = super()._scan(state, depths, gates)
        self.mesh.assert_replicated(state.pose, "the pose")
        return state, outs

    def _graph_route(self) -> bool:
        return self.device.type == "cuda" and self.mesh.capturable

    def render_volume_image(self, state: KFusionState) -> torch.Tensor:
        """The shaded volume from the current pose out to twice the far
        plane, composited across slabs like the raycast."""
        view = mat4mul(state.pose, get_inverse_camera_matrix(self._k))
        with self.timings.span("renderVolume", self.H * self.W):
            t_hit, hit_pos, g = self._slab_march(
                state.tsdf, view, params.FAR_PLANE * 2.0, True,
                ("render_halo", "render_pmin", "render_psum_normal"))
            hit_pos = torch.where(t_hit[None] > 0, hit_pos,
                                  torch.zeros_like(hit_pos))
            return shade(hit_pos, t_hit, g)

    def dump_volume(self, state: KFusionState, filename: str) -> None:
        """The whole volume's TSDF (gathered; rank 0 writes it)."""
        tsdf = self.mesh.all_gather_rows(state.tsdf, "state_all_gather")
        if self.rank == 0:
            tsdf.cpu().numpy().astype("<i2").tofile(filename)
