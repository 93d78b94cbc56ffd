"""Device entropy stage of the port: delta-wire unpack, kernel K1 (chunk
Huffman decode) and assembly into per-component stores."""
