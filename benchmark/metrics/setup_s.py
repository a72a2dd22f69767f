def read(ctx):
    """Process start to the first timed item: imports, the CUDA context,
    the inputs and the warm-up."""
    return ctx.setup_s
