"""Requests on images resident on the card: ``process_batch_jit``, the
replay of the forward's CUDA graph an image.  With CLAHE on,
``process_batch_jit`` drops the CLAHE image, so the request asks its graphs
for both outputs through ``graphs.run_batch``, the function it wraps."""

from benchmark.harness import entries

expected = entries.plain_expected


class Entry:
    pools = ("device",)
    keys = entries.KEYS

    def __init__(self, prog, cfg, pool, devices, options, seed):
        self.prog, self.cfg, self.pool, self.devices = prog, cfg, pool, list(devices)
        self.options = options
        self.products = entries.products(cfg)

    def submit(self, start: int, count: int) -> tuple:
        batch = self.pool[start:start + count]
        if self.products == ("out_u8",):
            return (self.prog.musica.process_batch_jit(batch, self.cfg, **self.options),)
        return self.prog.graphs.run_batch(self.prog.musica.musica_forward, batch, self.cfg,
                                          outputs=self.products, **self.options)

    def wait(self) -> None:
        entries.synchronize(self.devices[:1])
