"""The pyramid's bytes an image: the reduce ladder reads the normalized
image and writes every level's band and the top (the coarsest down), the
expand ladder reads the top and every level's band and writes the
reconstruction.  Levels the ladders pass between their own steps are not
counted.  Level sizes: s_0 = n, s_{i+1} = ceil(s_i / 2), ceil(log2 n)
levels, as the reference CLI builds them."""


def bytes_per_image(cfg) -> int:
    s = [cfg.image_size]
    for _ in range((cfg.image_size - 1).bit_length()):
        s.append(-(-s[-1] // 2))
    band = 2 if cfg.storage == "bfloat16" else 4
    band_px = sum(v * v for v in s[:-1])
    top, full = s[-1] ** 2, s[0] ** 2
    reduce = 4 * full + band * band_px + 4 * top
    expand = 4 * top + band * band_px + 4 * full
    return reduce + expand
