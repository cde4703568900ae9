from africanus_tpu_torch.dft.kernels import dft_plan, im_to_vis, vis_to_im

__all__ = ["im_to_vis", "vis_to_im", "dft_plan"]
