"""Device ops of the port: NTT domain, MSM, and the window-fold kernels."""
