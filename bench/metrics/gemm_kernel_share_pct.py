"""The share of the matrix products' device time (the operations of
``gemm_ms_per_step``, ``bench/patterns/gemm.txt``) spent in the port's 3xTF32
``wgmma`` kernel (``bench/patterns/gemm_kernel.txt``, whose name holds a
pattern of ``gemm.txt``): 0.0 where no product ran through it."""


def read(ctx):
    if ctx.trace is None:
        return None
    products = ctx.trace.matching_ns(ctx.patterns("gemm"))
    if not products:
        return None
    return 100.0 * ctx.trace.matching_ns(ctx.patterns("gemm_kernel")) / products
