"""train_rec.mfu: the steps' operations (forward and backward of the trunk
and the reconstruction head, 3 x ``count.trunk_flops_per_pixel`` a pixel
of each crop) over the epochs' wall, over the peak the convs run at (%)."""

from benchmark import count, readers
from benchmark.traffic.weights import net_widths


def read(run):
    steps, wall = run.counters.get("steps"), run.counters.get("wall_s")
    if not steps or not wall:
        return None
    cfg = run.config
    height, width = cfg["crop_size"]
    flops = (steps * 3.0 * count.trunk_flops_per_pixel(net_widths(cfg))
             * cfg["batch_size"] * height * width)
    return 100.0 * flops / wall / readers.train_peak(run)
