"""The whole step's share of the chips' bf16 peak: the model's operations
(``cb.work.model_flops_per_token``: 6 N_active + 6 L S H hd, no
recompute) of the steps outside the traced ones, over their wall seconds
times the chips times 989e12."""
from cb import work


def read(run):
    if run.free_steps <= 0 or run.free_s <= 0:
        return None
    cell = run.cell
    flops = work.model_flops_per_token(cell.config, cell.seq_len) \
        * cell.batch * cell.seq_len * run.free_steps
    return 100.0 * flops / (run.free_s * run.chips * work.PEAK_FLOPS_BF16)
