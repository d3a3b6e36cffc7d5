"""The hand-written CUDA kernels B1-B6 and their wrappers. Each wrapper
adds one to its module's launch counter where it launches its kernel;
:func:`launch_counts` reads them all and :func:`reset_launch_counts` sets
them to 0."""


def reset_launch_counts() -> None:
    """Every kernel's launch counter to 0."""
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels import spheres as ks

    kb.LAUNCHES = kb.LAUNCHES_FWD = kb.LAUNCHES_PARITY = 0
    ki.LAUNCHES = ki.LAUNCHES_BIG = 0
    kbb.LAUNCHES_BWD = kbb.LAUNCHES_BWD_RICH = 0
    ks.LAUNCHES = 0


def launch_counts() -> dict:
    """Every kernel's launches since :func:`reset_launch_counts`, by the
    kernel's name, B2's default and parity instantiations apart."""
    from srt_tpu_torch.kernels import bounce as kb
    from srt_tpu_torch.kernels import bounce_bwd as kbb
    from srt_tpu_torch.kernels import intersect as ki
    from srt_tpu_torch.kernels import spheres as ks

    return {"B1": kb.LAUNCHES, "B2": kb.LAUNCHES_FWD - kb.LAUNCHES_PARITY,
            "B2 parity": kb.LAUNCHES_PARITY, "B3": ki.LAUNCHES,
            "B4": ki.LAUNCHES_BIG, "B5": kbb.LAUNCHES_BWD,
            "B6": ks.LAUNCHES}
