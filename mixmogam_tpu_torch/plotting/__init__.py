from mixmogam_tpu_torch.plotting.plots import manhattan_plot, qq_plot

__all__ = ["manhattan_plot", "qq_plot"]
