"""Device math: Gramian accumulation, the scatter kernel, the finish."""
