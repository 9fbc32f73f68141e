"""VTK ImageData (.vti/.pvd) output of cell-centred fields (counterpart of
``thermalporous_tpu/io/vti.py``, the same bytes for the same fields).

On a structured grid the VTK container is ImageData: an XML header, then
the cell arrays as raw appended binary (each a uint64 byte count and its
payload), readable by ParaView and VisIt.  The native writer
(:mod:`thermalporous_torch.io.native`) is used when its library is built;
the pure-Python path below writes identical bytes.
"""

from __future__ import annotations

import os
import struct
import xml.sax.saxutils as sax

import numpy as np
import torch

from thermalporous_torch.core.grid import Grid
from thermalporous_torch.io import native

_VTK_TYPES = {
    np.dtype("float32"): "Float32",
    np.dtype("float64"): "Float64",
    np.dtype("int32"): "Int32",
    np.dtype("int64"): "Int64",
}


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_vtk_order(a: np.ndarray) -> np.ndarray:
    """The ``[ix, iy(, iz)]`` layout in VTK's x-fastest C order."""
    if a.ndim == 2:
        a = a[:, :, None]
    return np.ascontiguousarray(a.transpose(2, 1, 0))


def write_vti(
    path: str,
    grid: Grid,
    cell_fields: dict,
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> str:
    """Write cell-centred fields (numpy arrays or tensors of ``grid.shape``)
    to a .vti file, raw appended binary."""
    shape = grid.shape if grid.dim == 3 else (*grid.shape, 1)
    spacing = grid.spacing if grid.dim == 3 else (*grid.spacing, grid.thickness)
    nx, ny, nz = shape

    arrays = []
    offset = 0
    header_parts = []
    for name, arr in cell_fields.items():
        a = _host(arr)
        if a.shape != tuple(grid.shape):
            raise ValueError(f"field {name!r} has shape {a.shape}, want {grid.shape}")
        a = _to_vtk_order(a)
        if a.dtype not in _VTK_TYPES:
            a = a.astype(np.float64)
        raw = a.tobytes()
        header_parts.append(
            f'        <DataArray type="{_VTK_TYPES[a.dtype]}" Name="{sax.escape(name)}" '
            f'format="appended" offset="{offset}"/>'
        )
        arrays.append(raw)
        offset += 8 + len(raw)  # uint64 byte count + payload

    first = next(iter(cell_fields)) if cell_fields else ""
    xml = [
        '<?xml version="1.0"?>',
        '<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" '
        'header_type="UInt64">',
        f'  <ImageData WholeExtent="0 {nx} 0 {ny} 0 {nz}" '
        f'Origin="{origin[0]} {origin[1]} {origin[2]}" '
        f'Spacing="{spacing[0]} {spacing[1]} {spacing[2]}">',
        f'    <Piece Extent="0 {nx} 0 {ny} 0 {nz}">',
        f'      <CellData Scalars="{sax.escape(first)}">',
        *header_parts,
        "      </CellData>",
        "    </Piece>",
        "  </ImageData>",
        '  <AppendedData encoding="raw">',
    ]
    header = ("\n".join(xml) + "\n_").encode()
    footer = b"\n  </AppendedData>\n</VTKFile>\n"

    if native.write_vti_raw(path, header, arrays, footer):
        return path
    with open(path, "wb") as f:
        f.write(header)
        for raw in arrays:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
        f.write(footer)
    return path


class PVDWriter:
    """A time series: one .pvd index and a .vti per snapshot."""

    def __init__(self, directory: str, name: str, grid: Grid):
        self.directory = directory
        self.name = name
        self.grid = grid
        self.entries: list[tuple[float, str]] = []
        os.makedirs(directory, exist_ok=True)

    def write(self, t: float, cell_fields: dict) -> str:
        fname = f"{self.name}_{len(self.entries):05d}.vti"
        write_vti(os.path.join(self.directory, fname), self.grid, cell_fields)
        self.entries.append((t, fname))
        self._write_pvd()
        return fname

    def _write_pvd(self):
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="1.0" byte_order="LittleEndian">',
            "  <Collection>",
        ]
        for t, fname in self.entries:
            lines.append(f'    <DataSet timestep="{t}" group="" part="0" file="{fname}"/>')
        lines += ["  </Collection>", "</VTKFile>", ""]
        with open(os.path.join(self.directory, f"{self.name}.pvd"), "w") as f:
            f.write("\n".join(lines))


def state_fields(model, u) -> dict[str, np.ndarray]:
    """The named fields of a stacked state, on the host (one transfer)."""
    names = ["pressure", "temperature", "saturation_w"][: u.shape[0]]
    host = _host(u)
    return {n: host[i] for i, n in enumerate(names)}
