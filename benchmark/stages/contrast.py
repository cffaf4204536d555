"""The contrast stage's bytes an image (the curves, their apply and the
noise reduction): every level's band and each analysis level's sdev and
the CNR map read, every level's band for the expand written."""


def bytes_per_image(cfg) -> int:
    s = [cfg.image_size]
    for _ in range((cfg.image_size - 1).bit_length()):
        s.append(-(-s[-1] // 2))
    band = 2 if cfg.storage == "bfloat16" else 4
    band_px = sum(v * v for v in s[:-1])
    analysis = [i for i in range(len(s) - 1)
                if i < cfg.coarser_levels_start or i <= cfg.cnr_level]
    sdev_px = sum(s[i] ** 2 for i in analysis)
    return 2 * band * band_px + 4 * sdev_px + 4 * s[cfg.cnr_level] ** 2
