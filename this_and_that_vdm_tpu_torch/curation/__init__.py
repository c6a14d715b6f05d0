"""Dataset curation of the port: raw Bridge trees to flat instance folders."""
