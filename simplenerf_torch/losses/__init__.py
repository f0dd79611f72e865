from simplenerf_torch.losses.computer import LossComputer, LossContext

__all__ = ["LossComputer", "LossContext"]
