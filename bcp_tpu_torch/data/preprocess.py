"""Raw-format I/O and the offline raw -> HDF5 converters:
``bcp_tpu/data/preprocess.py`` for the port.

The two reference converters:

- LA: NRRD pairs -> bbox-cropped z-scored volumes -> ``mri_norm2.h5``
  (`dataloaders/la_heart_processing.py:9-40`);
- ACDC: NIfTI volumes -> min-max normalised per-slice h5
  (`dataloaders/acdc_data_processing.py:8-37`).

The reference reads with nrrd / SimpleITK; here minimal pure-numpy readers
stand in (NRRD: text header, raw or gzip payload; NIfTI-1: single-file
``.nii`` / ``.nii.gz``), with a NIfTI-1 writer behind the test CLIs'
``--save_result``. ``h5py`` is imported by the converters only, so the
readers and the writer work without it.

    python -m bcp_tpu_torch.data.preprocess la --raw_root DATA/LA_raw
    python -m bcp_tpu_torch.data.preprocess acdc --image_dir IMG \\
        --output_dir OUT
"""

from __future__ import annotations

import glob
import gzip
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------------
# minimal format readers

_NRRD_DTYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "float": np.float32, "double": np.float64,
}


def read_nrrd(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """Minimal NRRD reader: text header, raw/gzip encodings, C order
    with NRRD's fastest-first axis convention (matches pynrrd's default
    Fortran-style index order)."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path}: not a NRRD file")
        header: Dict[str, str] = {}
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("ascii", "ignore").strip()
            if text.startswith("#") or ":" not in text:
                continue
            key, value = text.split(":", 1)
            header[key.strip().lower()] = value.lstrip("= ").strip()
        payload = f.read()

    dtype = np.dtype(_NRRD_DTYPES[header["type"]])
    if header.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")
    sizes = [int(s) for s in header["sizes"].split()]
    encoding = header.get("encoding", "raw")
    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding != "raw":
        raise ValueError(f"unsupported NRRD encoding {encoding!r}")
    data = np.frombuffer(payload, dtype=dtype,
                         count=int(np.prod(sizes)))
    # NRRD lists sizes fastest-first; pynrrd returns index order (i,j,k)
    return data.reshape(sizes[::-1]).transpose(
        range(len(sizes))[::-1]), header


_NIFTI_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
                 64: np.float64, 256: np.int8, 512: np.uint16,
                 768: np.uint32}


def read_nifti(path: str) -> np.ndarray:
    """Minimal NIfTI-1 reader (single-file .nii / .nii.gz), returning the
    array in (z, y, x) order like SimpleITK's GetArrayFromImage (the
    convention the ACDC converter relies on)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<" if sizeof_hdr == 348 else ">"
        dim = struct.unpack(endian + "8h", hdr[40:56])
        ndim = dim[0]
        shape = dim[1:1 + ndim]
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        vox_offset = int(struct.unpack(endian + "f", hdr[108:112])[0])
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
        f.seek(vox_offset)
        dtype = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(endian)
        data = np.frombuffer(f.read(), dtype=dtype,
                             count=int(np.prod(shape)))
    vol = data.reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        vol = vol * slope + scl_inter
    # (x, y, z[,t]) fortran -> (z, y, x) like sitk.GetArrayFromImage
    return np.transpose(vol, axes=range(vol.ndim)[::-1])


_NIFTI_CODES = {np.dtype(v).name: k for k, v in _NIFTI_DTYPES.items()}


def write_nifti(path: str, array: np.ndarray,
                spacing: Tuple[float, ...] = (1.0, 1.0, 1.0)) -> None:
    """Minimal NIfTI-1 writer (single-file .nii / .nii.gz), the inverse of
    ``read_nifti``: ``read_nifti(write_nifti(p, a)) == a``.

    Used by the eval CLIs' ``--save_result`` prediction dumps; the
    reference writes float32 volumes with an identity affine via nibabel
    (`utils/test_3d_patch.py:67-72`) or SimpleITK with per-axis spacing
    (`test_ACDC.py:70-75`). Like those, the (z, y, x) array convention is
    stored as an (x, y, z) fortran-order file. A ``.gz`` file is
    compressed at level 1: once decompressed, the bytes of the JAX
    writer, which takes gzip's default level 9; at level 9 the dumps of
    two 240x200x96 LA cases added 3.76 s a case to ``test_la``'s 3.48 on
    the H100 machine's host (PERF.md).
    """
    array = np.asarray(array)
    if array.dtype.name not in _NIFTI_CODES:
        array = array.astype(np.float32)
    code = _NIFTI_CODES[array.dtype.name]
    ndim = array.ndim
    dim = [ndim] + list(array.shape[::-1]) + [1] * (7 - ndim)
    pixdim = ([1.0] + list(spacing)[:ndim]
              + [1.0] * (7 - min(ndim, len(spacing))))[:8]
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)                    # sizeof_hdr
    struct.pack_into("<8h", hdr, 40, *dim)                 # dim
    struct.pack_into("<h", hdr, 70, code)                  # datatype
    struct.pack_into("<h", hdr, 72, array.dtype.itemsize * 8)  # bitpix
    struct.pack_into(f"<{len(pixdim)}f", hdr, 76, *pixdim)  # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)                  # scl_inter
    hdr[123] = 2                                           # units: mm
    struct.pack_into("<h", hdr, 254, 1)                    # sform_code
    for row, sp in enumerate(pixdim[1:4]):                 # srow diag
        struct.pack_into("<4f", hdr, 280 + 16 * row,
                         *(sp if i == row else 0.0 for i in range(3)), 0.0)
    hdr[344:348] = b"n+1\x00"                              # magic
    with (gzip.open(path, "wb", compresslevel=1) if path.endswith(".gz")
          else open(path, "wb")) as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)                               # no extensions
        f.write(array.tobytes(order="C"))


# --------------------------------------------------------------------------
# converters

def convert_la(raw_root: str, output_size=(112, 112, 80),
               seed: Optional[int] = None) -> int:
    """`la_heart_processing.covert_h5` (`la_heart_processing.py:9-40`):
    label = (laendo == 255); bbox of the label grown by a random 10-20
    voxel margin (5-10 in z) and at least the output size; z-score the
    image; write mri_norm2.h5 next to the source."""
    import h5py
    rng = np.random.default_rng(seed)
    items = sorted(glob.glob(os.path.join(
        raw_root, "2018LA_Seg_Training Set", "*", "lgemri.nrrd")))
    count = 0
    for item in items:
        image, _ = read_nrrd(item)
        label_raw, _ = read_nrrd(item.replace("lgemri.nrrd",
                                              "laendo.nrrd"))
        label = (label_raw == 255).astype(np.uint8)
        w, h, d = label.shape
        nz = np.nonzero(label)
        minx, maxx = np.min(nz[0]), np.max(nz[0])
        miny, maxy = np.min(nz[1]), np.max(nz[1])
        minz, maxz = np.min(nz[2]), np.max(nz[2])
        px = max(output_size[0] - (maxx - minx), 0) // 2
        py = max(output_size[1] - (maxy - miny), 0) // 2
        pz = max(output_size[2] - (maxz - minz), 0) // 2
        minx = max(minx - int(rng.integers(10, 20)) - px, 0)
        maxx = min(maxx + int(rng.integers(10, 20)) + px, w)
        miny = max(miny - int(rng.integers(10, 20)) - py, 0)
        maxy = min(maxy + int(rng.integers(10, 20)) + py, h)
        minz = max(minz - int(rng.integers(5, 10)) - pz, 0)
        maxz = min(maxz + int(rng.integers(5, 10)) + pz, d)
        image = ((image - np.mean(image)) / np.std(image)).astype(
            np.float32)
        image = image[minx:maxx, miny:maxy]
        label = label[minx:maxx, miny:maxy]
        out = item.replace("lgemri.nrrd", "mri_norm2.h5")
        with h5py.File(out, "w") as f:
            f.create_dataset("image", data=image, compression="gzip")
            f.create_dataset("label", data=label, compression="gzip")
        count += 1
    return count


def convert_acdc(image_dir: str, output_dir: str) -> int:
    """`acdc_data_processing` (`acdc_data_processing.py:8-37`): for each
    <case>.nii.gz with a <case>_gt.nii.gz label, min-max normalise the
    volume and write one h5 per slice."""
    import h5py
    os.makedirs(output_dir, exist_ok=True)
    slice_num = 0
    for case in sorted(glob.glob(os.path.join(image_dir, "*.nii.gz"))):
        msk_path = case.replace("image", "label").replace(
            ".nii.gz", "_gt.nii.gz")
        if not os.path.exists(msk_path):
            continue
        image = read_nifti(case).astype(np.float32)
        mask = read_nifti(msk_path)
        image = (image - image.min()) / max(image.max() - image.min(),
                                            1e-8)
        item = os.path.basename(case).split(".")[0]
        for ind in range(image.shape[0]):
            out = os.path.join(output_dir, f"{item}_slice_{ind}.h5")
            with h5py.File(out, "w") as f:
                f.create_dataset("image", data=image[ind],
                                 compression="gzip")
                f.create_dataset("label", data=mask[ind],
                                 compression="gzip")
            slice_num += 1
    return slice_num


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="raw -> h5 converters")
    sub = p.add_subparsers(dest="cmd", required=True)
    la = sub.add_parser("la")
    la.add_argument("--raw_root", required=True)
    ac = sub.add_parser("acdc")
    ac.add_argument("--image_dir", required=True)
    ac.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "la":
        n = convert_la(args.raw_root)
        print(f"converted {n} LA volumes")
    else:
        n = convert_acdc(args.image_dir, args.output_dir)
        print("Converted all ACDC volumes to 2D slices")
        print(f"Total {n} slices")


if __name__ == "__main__":
    main()
