"""The Tier-1 kernels' share of their roofline, in %: the least time the
card could take for the Tier-1 work of the window's images (their least
bytes at the HBM peak, ``harness/roofline.py``) over the device time of
the repository's own kernels in the traced window."""
from benchmark.harness import roofline


def read(run):
    if run.device is None or not run.device["own_kernel_s"]:
        return None
    least = sum(roofline.tier1_least_bytes(px, comps, nbytes)
                for px, comps, nbytes in run.objects)
    return 100.0 * roofline.least_seconds(least) / run.device["own_kernel_s"]
