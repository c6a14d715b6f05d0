"""Host-side data preparation of the port (numpy only): gesture rasters,
the bicubic resize, image sizes from file headers, prompt rewriting."""
