"""JPEG bitstream codec: markers, tables, header model, scanner, huffman, entropy.

Replacement for the reference host frontend
(reference: src/jpeg_scanner.cpp, src/headers/jpeg.h). The scanner produces
parsed tables plus the de-stuffed entropy byte stream with restart-segment
offsets, so entropy decode can run either sequentially (host) or
segment-parallel.
"""
