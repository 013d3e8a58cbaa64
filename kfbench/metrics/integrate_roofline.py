"""The least time the integrate could take, the bytes the frame needs at
the HBM peak (``stats.integrate_bytes``: each voxel the frame updates
read and written once, the depth map read once), over the integration
phase's device ms (``integrate_ms``)."""

from kfbench.stats import integrate_bytes, roofline_pct


def read(ctx):
    ms = ctx.get("phase_ms", {}).get("integration")
    if not ms or ctx.get("updated_voxels") is None:
        return None
    return roofline_pct(integrate_bytes(ctx["updated_voxels"],
                                        ctx["depth_pixels"]), ms)
