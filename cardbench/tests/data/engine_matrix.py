"""A test's engine adapter over ``bbcat_dsp_torch.convolve.
MatrixConvolver``: ``C_in`` inputs mixed to ``C_out`` outputs, one block a
live call, an exchange faded over the next block.  The program takes its
filters as host NumPy, so ``prepare`` makes the host copy in set-up and
``exchange`` hands it over."""

from bbcat_dsp_torch import ops_hook
from bbcat_dsp_torch.convolve import MatrixConvolver

__all__ = ["Engine"]


class Engine:
    cycle_blocks = 1

    def __init__(self, cfg, filters, device):
        self.conv = MatrixConvolver(filters.cpu().numpy(), cfg["block"],
                                    device=device)
        self.block = self.conv.block

    def live(self, x):
        return self.conv.process_block(x)

    @staticmethod
    def prepare(filters):
        return filters.cpu().numpy()

    def exchange(self, prepared):
        self.conv.set_filter_matrix(prepared)

    @staticmethod
    def shapes(entry):
        return {}

    @staticmethod
    def counts():
        return ops_hook.counts()
