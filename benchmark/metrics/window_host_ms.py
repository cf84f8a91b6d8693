"""Sampler (diffusion/gaussian_diffusion.py): host ms a window outside its
reverse loop (canonicalization, decode, the next window's inpaint FK, the
stitch), from the spans around ``_sample_window`` and ``_loop``."""


def read(ctx):
    s = ctx.spans
    n = len(s["sample_window"])
    if not n:
        return None
    return (sum(s["sample_window"]) - sum(s["reverse_loop"])) / n * 1e3
