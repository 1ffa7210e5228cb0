"""The yardstick of the MSM kernels' roofline share: the least work of a
Pippenger MSM at a fixed window of c = 8, counted from the signed digits
the MSMs were given, and the card's peaks.  The counts are fixed here, not
taken from the program, so the same inputs count the same whatever
implements them.

Work of one MSM of k scalar vectors over n points:
  mixed additions  one per non-zero signed digit (into its bucket)
  bucket sums      each of the k * 32 windows sums its 128 buckets by the
                   running-sum method: 2 * 128 full additions
  window sums      Horner over the 32 windows of each vector: 31 * 8
                   doublings and 31 full additions
F_p multiplications (squarings count as multiplications) per operation:
a mixed addition 7 (the source's 2d*x*y given), a full addition 9, a
doubling 8.  A multiplication is 64 products of 32 x 32 -> 64 bits (the
8 x 8 limb products of a 256-bit product; its reduction is not counted).

Bytes: each source point read once as its affine x and y (64 bytes) and
each signed digit once (1 byte: 32 per scalar).
"""

C = 8
WINDOWS = 256 // C
BUCKETS = 1 << (C - 1)
MUL = {"madd": 7, "add": 9, "dbl": 8}
PRODUCTS_PER_MUL = 64
POINT_BYTES = 64

# NVIDIA H100 SXM: CUDA C++ Programming Guide, "Arithmetic Instructions",
# compute capability 9.0: 64 results per clock per SM of 32-bit integer
# multiply and multiply-add; 132 SMs; HBM3 at 3.35 TB/s (data sheet).
INT32_MUL_PER_CLOCK_PER_SM = 64
SMS = 132
HBM_BYTES_PER_S = 3.35e12

# the program's MSM kernels (K1-K5, K7 and the cols / flat layouts' K8-K10)
# by the names the device trace gives them
KERNELS = ("bucket_accumulate", "bucket_merge", "window_sums_kernel",
           "horner_kernel", "point_sum_kernel")


def msm_work(k: int, n: int, nonzero_digits: int):
    """(32x32 products, bytes) of one MSM."""
    windows = k * WINDOWS
    muls = (nonzero_digits * MUL["madd"]
            + windows * 2 * BUCKETS * MUL["add"]
            + k * (WINDOWS - 1) * (C * MUL["dbl"] + MUL["add"]))
    return muls * PRODUCTS_PER_MUL, n * POINT_BYTES + windows * n


def least_seconds(products, nbytes, sm_clock_hz):
    """(least seconds, which bound) on one H100 at `sm_clock_hz`."""
    compute = products / (INT32_MUL_PER_CLOCK_PER_SM * SMS * sm_clock_hz)
    memory = nbytes / HBM_BYTES_PER_S
    return (compute, "compute") if compute >= memory else (memory, "bytes")


def kernel_seconds(kernels):
    return sum(s for name, s in kernels.items()
               if any(k in name for k in KERNELS))


def share(ctx):
    """Percent of the MSM kernels' device time that the least time is, or
    None where the window ran no MSM or nvidia-smi gave no clock."""
    seconds = kernel_seconds(ctx.kernels)
    clock_mhz = ctx.gpu.get("clocks.max.sm")
    if not ctx.msm_digits or seconds <= 0 or not clock_mhz:
        return None
    products = nbytes = 0
    for k, n, nz in ctx.msm_digits:
        p, b = msm_work(k, n, nz)
        products += p
        nbytes += b
    least, _ = least_seconds(products, nbytes, clock_mhz * 1e6)
    return 100.0 * least / seconds
