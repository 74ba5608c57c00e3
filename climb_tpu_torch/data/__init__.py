"""The host data path: datasets on a CLiMB data root and synthetic ones,
tokenization, image canvases, parse caches, collation, and the prefetching
loader that feeds the card."""
