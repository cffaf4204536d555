"""The CLAHE group's bytes an image: with linear gradation, the squared
image (the reconstruction read, its square written); the joint histogram's
CNR map read (the reconstruction and the normalized image it reads where a
pixel may be relevant depend on the data and are not counted, so the share
is a lower bound); the LUTs (histograms read, curves written); the blended
apply (the reconstruction and the LUTs read, the CLAHE image written)."""


def bytes_per_image(cfg) -> int:
    n = cfg.image_size
    full = n * n
    cnr_side = n
    for _ in range(cfg.cnr_level):
        cnr_side = -(-cnr_side // 2)
    luts = cfg.clahe_tiles ** 2 * cfg.clahe_bins
    total = 4 * cnr_side ** 2 + 4 * luts + 4 * (luts + cfg.clahe_bins)
    total += 4 * full + 4 * (luts + cfg.clahe_bins) + 4 * full
    if cfg.grad_with_linear_image:
        total += 2 * 4 * full
    return total
