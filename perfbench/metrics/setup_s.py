"""setup_s (host clock): from the process's start to the first timed
batch: imports, CUDA context, genome, index image, aligner, the run's
batches and the warm-up batches; not the profiler's first session, which
only the benchmark runs (printed apart as ``profiling_s``)."""


def read(ctx):
    return ctx.setup_s
