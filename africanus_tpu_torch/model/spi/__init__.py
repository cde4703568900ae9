from africanus_tpu_torch.model.spi.component_spi import fit_spi_components

__all__ = ["fit_spi_components"]
