"""Self-contained HDF5 reader: a copy of the reference's
``deeplearning4j_tpu/utils/h5.py`` (the role of the reference's libhdf5
binding for Keras import, ``Hdf5Archive.java``), so Keras import does not
rest on h5py, which a GPU host need not have.

Scope: the subset Keras ``model.save()`` files (h5py-written) use —
superblock v0/v2/v3, v1 and v2 object headers (with continuations),
old-style symbol-table groups (B-tree v1 + local heap + SNOD) and new-style
link messages, attributes (v1/v3) including variable-length strings via the
global heap, datasets with compact/contiguous/chunked layout (chunk B-tree
v1) and the deflate filter, fixed-point / IEEE-float / string / vlen-string
datatypes. Anything else raises :class:`H5Error`.

API mirrors the slice of h5py the importer consumes::

    with H5File(path) as f:
        f.attrs["model_config"]       # decoded attribute
        g = f["model_weights"]        # group traversal, "a/b" paths OK
        "dense_1" in g                # membership
        np.asarray(g["dense_1_W"])    # dataset -> ndarray
        g.attrs.get("weight_names")   # vlen-str array attributes
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional

import numpy as np

__all__ = ["H5Dataset", "H5Error", "H5File", "H5Group"]

_UNDEF = 0xFFFFFFFFFFFFFFFF


class H5Error(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.d = data

    def u(self, off, n):
        return int.from_bytes(self.d[off:off + n], "little")

    def bytes_at(self, off, n):
        return self.d[off:off + n]


class H5Dataset:
    """Lazy dataset; ``np.asarray(ds)`` / ``ds[()]`` materialize it."""

    def __init__(self, file, shape, dtype_info, layout):
        self._file = file
        self.shape = shape
        self._dtype_info = dtype_info
        self._layout = layout

    def __array__(self, dtype=None, copy=None):
        arr = self._file._read_dataset(self)
        return arr.astype(dtype) if dtype is not None else arr

    def __getitem__(self, key):
        return self._file._read_dataset(self)[key]


class H5Group:
    def __init__(self, file, header_addr):
        self._file = file
        self._addr = header_addr
        self._links: Optional[Dict[str, int]] = None
        self._attrs: Optional[dict] = None

    # -- lazy parses ---------------------------------------------------
    def _ensure(self):
        if self._links is None:
            self._links, self._attrs, self._ds = \
                self._file._parse_object(self._addr)

    @property
    def attrs(self):
        self._ensure()
        return self._attrs

    def keys(self):
        self._ensure()
        return list(self._links)

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, name):
        try:
            self[name]
            return True
        except KeyError:
            return False

    def __getitem__(self, path):
        node = self
        parts = path.strip("/").split("/")
        for i, part in enumerate(parts):
            if isinstance(node, H5Dataset):
                # dataset mid-path: same KeyError h5py raises
                raise KeyError(path)
            node._ensure()
            if part not in node._links:
                raise KeyError(path)
            child = H5Group(node._file, node._links[part])
            child._ensure()
            if child._ds is not None:
                obj = H5Dataset(child._file, *child._ds)
                obj.attrs = child._attrs
                node = obj
            else:
                node = child
        return node


class H5File(H5Group):
    def __init__(self, path):
        with open(path, "rb") as f:
            self._r = _Reader(f.read())
        root = self._parse_superblock()
        super().__init__(self, root)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    # -- superblock ----------------------------------------------------
    def _parse_superblock(self):
        d = self._r.d
        sig = b"\x89HDF\r\n\x1a\n"
        base = d.find(sig)
        if base != 0:
            raise H5Error("not an HDF5 file")
        version = d[8]
        if version in (0, 1):
            self._off_size = d[13]
            self._len_size = d[14]
            gl = 24
            if version == 1:
                gl += 4
            # root group symbol-table entry: link-name offset + header addr
            ste = gl + 4 * self._off_size
            return self._r.u(ste + self._off_size, self._off_size)
        if version in (2, 3):
            self._off_size = d[9]
            self._len_size = d[10]
            return self._r.u(12 + 3 * self._off_size, self._off_size)
        raise H5Error(f"unsupported superblock version {version}")

    # -- object headers ------------------------------------------------
    def _parse_object(self, addr):
        """Return (links, attrs, dataset_info|None) for the object at addr."""
        msgs = []
        d = self._r.d
        if d[addr:addr + 4] == b"OHDR":      # v2 object header
            self._collect_v2_messages(addr, msgs)
        else:                                 # v1
            self._collect_v1_messages(addr, msgs)
        links: Dict[str, int] = {}
        attrs: dict = {}
        shape = dtype_info = layout = None
        filters = []
        for mtype, body in msgs:
            if mtype == 0x11:   # symbol table (old-style group)
                btree = int.from_bytes(body[:self._off_size], "little")
                heap = int.from_bytes(
                    body[self._off_size:2 * self._off_size], "little")
                self._walk_btree_group(btree, heap, links)
            elif mtype == 0x06:  # link message (new-style group)
                name, target = self._parse_link_message(body)
                if name is not None:
                    links[name] = target
            elif mtype == 0x02:  # link info (fractal heap groups unsupported)
                pass
            elif mtype == 0x0C:  # attribute
                name, value = self._parse_attribute(body)
                attrs[name] = value
            elif mtype == 0x01:  # dataspace
                shape = self._parse_dataspace(body)
            elif mtype == 0x03:  # datatype
                dtype_info = self._parse_datatype(body)
            elif mtype == 0x08:  # layout
                layout = self._parse_layout(body)
            elif mtype == 0x0B:  # filter pipeline
                filters = self._parse_filters(body)
        ds = None
        if layout is not None and dtype_info is not None:
            ds = (shape if shape is not None else (),
                  dtype_info, (layout, filters))
        return links, attrs, ds

    def _collect_v1_messages(self, addr, out):
        r = self._r
        nmsgs = r.u(addr + 2, 2)
        block_size = r.u(addr + 8, 4)
        pos = addr + 16
        end = pos + block_size
        seen = 0
        stack = [(pos, end)]
        while stack and seen < nmsgs:
            pos, end = stack.pop()
            while pos + 8 <= end and seen < nmsgs:
                mtype = r.u(pos, 2)
                msize = r.u(pos + 2, 2)
                body = r.bytes_at(pos + 8, msize)
                pos += 8 + msize
                seen += 1
                if mtype == 0x10:   # continuation
                    caddr = int.from_bytes(body[:self._off_size], "little")
                    clen = int.from_bytes(
                        body[self._off_size:self._off_size + self._len_size],
                        "little")
                    stack.append((pos, end))
                    pos, end = caddr, caddr + clen
                else:
                    out.append((mtype, body))

    def _collect_v2_messages(self, addr, out):
        r = self._r
        flags = r.d[addr + 5]
        pos = addr + 6
        if flags & 0x20:
            pos += 16           # access/mod/change/birth timestamps
        if flags & 0x10:
            pos += 4            # max-compact / min-dense attribute counts
        size_bytes = 1 << (flags & 0x03)
        chunk_size = r.u(pos, size_bytes)
        pos += size_bytes
        end = pos + chunk_size
        track = bool(flags & 0x04)
        stack = [(pos, end)]
        while stack:
            pos, end = stack.pop()
            while pos + 4 <= end - 0:   # gap for checksum handled by size
                mtype = r.u(pos, 1)
                msize = r.u(pos + 1, 2)
                pos += 4
                if track:
                    pos += 2
                if mtype == 0 and msize == 0:
                    break
                body = r.bytes_at(pos, msize)
                pos += msize
                if mtype == 0x10:
                    caddr = int.from_bytes(body[:self._off_size], "little")
                    clen = int.from_bytes(
                        body[self._off_size:self._off_size + self._len_size],
                        "little")
                    stack.append((pos, end))
                    # continuation blocks start with OCHK signature
                    pos, end = caddr + 4, caddr + clen - 4
                else:
                    out.append((mtype, body))

    # -- old-style groups ---------------------------------------------
    def _walk_btree_group(self, btree_addr, heap_addr, links):
        r = self._r
        if r.d[btree_addr:btree_addr + 4] != b"TREE":
            raise H5Error("bad group B-tree signature")
        level = r.d[btree_addr + 5]
        entries = r.u(btree_addr + 6, 2)
        pos = btree_addr + 8 + 2 * self._off_size
        pos += self._len_size   # key 0
        for _ in range(entries):
            child = r.u(pos, self._off_size)
            pos += self._off_size + self._len_size
            if level > 0:
                self._walk_btree_group(child, heap_addr, links)
            else:
                self._walk_snod(child, heap_addr, links)

    def _walk_snod(self, addr, heap_addr, links):
        r = self._r
        if r.d[addr:addr + 4] != b"SNOD":
            raise H5Error("bad symbol node signature")
        n = r.u(addr + 6, 2)
        pos = addr + 8
        heap_data = self._local_heap_data(heap_addr)
        for _ in range(n):
            name_off = r.u(pos, self._off_size)
            header = r.u(pos + self._off_size, self._off_size)
            name_end = self._r.d.index(b"\x00", heap_data + name_off)
            name = self._r.d[heap_data + name_off:name_end].decode()
            links[name] = header
            pos += 2 * self._off_size + 4 + 4 + 16

    def _local_heap_data(self, heap_addr):
        r = self._r
        if r.d[heap_addr:heap_addr + 4] != b"HEAP":
            raise H5Error("bad local heap signature")
        return r.u(heap_addr + 8 + 2 * self._len_size, self._off_size)

    def _parse_link_message(self, body):
        ver = body[0]
        if ver != 1:
            return None, None
        flags = body[1]
        pos = 2
        ltype = 0
        if flags & 0x08:
            ltype = body[pos]
            pos += 1
        if flags & 0x04:
            pos += 8    # creation order
        if flags & 0x10:
            pos += 1    # charset
        lsize = 1 << (flags & 0x03)
        nlen = int.from_bytes(body[pos:pos + lsize], "little")
        pos += lsize
        name = body[pos:pos + nlen].decode()
        pos += nlen
        if ltype != 0:
            return None, None   # soft/external links out of scope
        return name, int.from_bytes(body[pos:pos + self._off_size], "little")

    # -- messages ------------------------------------------------------
    def _parse_dataspace(self, body):
        ver = body[0]
        rank = body[1]
        if ver == 1:
            flags = body[2]
            pos = 8
        else:
            flags = body[2]
            pos = 4
        dims = []
        for i in range(rank):
            dims.append(int.from_bytes(
                body[pos + i * self._len_size:
                     pos + (i + 1) * self._len_size], "little"))
        return tuple(dims)

    def _parse_datatype(self, body):
        cls = body[0] & 0x0F
        ver = body[0] >> 4
        bits0, bits8, bits16 = body[1], body[2], body[3]
        size = int.from_bytes(body[4:8], "little")
        if cls == 0:     # fixed-point
            signed = bool(bits0 & 0x08)
            endian = ">" if bits0 & 0x01 else "<"
            return ("int", np.dtype(
                f"{endian}{'i' if signed else 'u'}{size}"))
        if cls == 1:     # IEEE float
            endian = ">" if bits0 & 0x01 else "<"
            return ("float", np.dtype(f"{endian}f{size}"))
        if cls == 3:     # fixed string
            return ("str", size)
        if cls == 9:     # vlen
            base = self._parse_datatype(body[8:])
            is_str = bool(bits0 & 0x01)
            return ("vlen_str" if is_str else "vlen", base)
        if cls == 6:     # compound — out of scope
            raise H5Error("compound datatypes not supported")
        raise H5Error(f"unsupported datatype class {cls} (v{ver})")

    def _parse_layout(self, body):
        ver = body[0]
        if ver == 3:
            lclass = body[1]
            if lclass == 0:    # compact
                n = int.from_bytes(body[2:4], "little")
                return ("compact", body[4:4 + n])
            if lclass == 1:    # contiguous
                addr = int.from_bytes(body[2:2 + self._off_size], "little")
                n = int.from_bytes(
                    body[2 + self._off_size:
                         2 + self._off_size + self._len_size], "little")
                return ("contiguous", addr, n)
            if lclass == 2:    # chunked
                rank = body[2]
                addr = int.from_bytes(body[3:3 + self._off_size], "little")
                pos = 3 + self._off_size
                dims = [int.from_bytes(body[pos + 4 * i:pos + 4 * (i + 1)],
                                       "little") for i in range(rank)]
                return ("chunked", addr, dims)
        if ver == 4:
            # v4 (libver=latest): compact/contiguous share v3's shape; the
            # new chunk indexes (single/implicit/fixed/extensible array,
            # B-tree v2) are out of scope — Keras files use v0/earliest
            lclass = body[1]
            if lclass == 0:
                n = int.from_bytes(body[2:4], "little")
                return ("compact", body[4:4 + n])
            if lclass == 1:
                addr = int.from_bytes(body[2:2 + self._off_size], "little")
                n = int.from_bytes(
                    body[2 + self._off_size:
                         2 + self._off_size + self._len_size], "little")
                return ("contiguous", addr, n)
            raise H5Error("v4 chunked layouts not supported "
                          "(write with libver='earliest')")
        raise H5Error(f"unsupported data layout version {ver}")

    def _parse_filters(self, body):
        ver = body[0]
        n = body[1]
        out = []
        pos = 8 if ver == 1 else 2
        for _ in range(n):
            fid = int.from_bytes(body[pos:pos + 2], "little")
            if ver == 1 or fid >= 256:
                nlen = int.from_bytes(body[pos + 2:pos + 4], "little")
                ncv = int.from_bytes(body[pos + 6:pos + 8], "little")
                pos += 8 + nlen + (nlen % 8 and 8 - nlen % 8 or 0)
            else:
                ncv = int.from_bytes(body[pos + 6:pos + 8], "little")
                pos += 8
            pos += 4 * ncv
            if ver == 1 and ncv % 2:
                pos += 4
            out.append(fid)
        return out

    def _parse_attribute(self, body):
        ver = body[0]
        if ver == 1:
            nlen = int.from_bytes(body[2:4], "little")
            dsize = int.from_bytes(body[4:6], "little")
            ssize = int.from_bytes(body[6:8], "little")
            pos = 8
            pad = lambda x: (x + 7) & ~7          # noqa: E731
            name = body[pos:pos + nlen].split(b"\x00")[0].decode()
            pos += pad(nlen)
            dt = body[pos:pos + dsize]
            pos += pad(dsize)
            sp = body[pos:pos + ssize]
            pos += pad(ssize)
        elif ver == 3:
            nlen = int.from_bytes(body[2:4], "little")
            dsize = int.from_bytes(body[4:6], "little")
            ssize = int.from_bytes(body[6:8], "little")
            pos = 9   # +1 charset
            name = body[pos:pos + nlen].split(b"\x00")[0].decode()
            pos += nlen
            dt = body[pos:pos + dsize]
            pos += dsize
            sp = body[pos:pos + ssize]
            pos += ssize
        else:
            raise H5Error(f"unsupported attribute version {ver}")
        dtype_info = self._parse_datatype(dt)
        shape = self._parse_dataspace(sp) if len(sp) >= 2 else ()
        return name, self._decode_values(body[pos:], dtype_info, shape)

    # -- value decoding ------------------------------------------------
    def _decode_values(self, raw, dtype_info, shape):
        kind = dtype_info[0]
        count = int(np.prod(shape)) if shape else 1
        # corrupted headers can claim absurd element counts; validate the
        # claimed payload against the bytes actually present BEFORE any
        # per-element loop (a bogus multi-million count would otherwise
        # spin for minutes producing empty values)
        per = (dtype_info[1].itemsize if kind in ("int", "float")
               else dtype_info[1] if kind == "str"
               else 8 + self._off_size if kind == "vlen_str" else 1)
        if count < 0 or count * per > len(raw):
            raise H5Error(
                f"attribute claims {count} x {per}B values but only "
                f"{len(raw)} bytes are present (corrupt header)")
        if kind in ("int", "float"):
            dt = dtype_info[1]
            arr = np.frombuffer(raw[:count * dt.itemsize], dtype=dt)
            arr = arr.astype(dt.newbyteorder("=")).reshape(shape)
            return arr if shape else arr[()]
        if kind == "str":
            size = dtype_info[1]
            vals = [raw[i * size:(i + 1) * size].split(b"\x00")[0].decode()
                    for i in range(count)]
            return np.array(vals) if shape else vals[0]
        if kind == "vlen_str":
            vals = []
            for i in range(count):
                off = i * (4 + self._off_size + 4)
                heap_addr = int.from_bytes(
                    raw[off + 4:off + 4 + self._off_size], "little")
                idx = int.from_bytes(
                    raw[off + 4 + self._off_size:
                        off + 8 + self._off_size], "little")
                vals.append(self._global_heap_object(heap_addr, idx).decode())
            return np.array(vals) if shape else vals[0]
        raise H5Error(f"unsupported attribute kind {kind}")

    def _global_heap_object(self, addr, want_idx):
        r = self._r
        if r.d[addr:addr + 4] != b"GCOL":
            raise H5Error("bad global heap signature")
        size = r.u(addr + 8, self._len_size)
        pos = addr + 8 + self._len_size
        end = addr + size
        # object header: index(2) refcount(2) reserved(4) size(len_size),
        # then data padded to a multiple of 8
        hdr = 8 + self._len_size
        while pos + hdr <= end:
            idx = r.u(pos, 2)
            osize = r.u(pos + 8, self._len_size)
            if idx == want_idx:
                return r.bytes_at(pos + hdr, osize)
            if idx == 0:
                break
            pos += hdr + ((osize + 7) & ~7)
        raise H5Error(f"global heap object {want_idx} not found")

    # -- dataset reads -------------------------------------------------
    def _read_dataset(self, ds: H5Dataset):
        (layout, filters) = ds._layout
        kind = ds._dtype_info[0]
        if kind not in ("int", "float"):
            raise H5Error("only numeric datasets supported")
        dt = ds._dtype_info[1]
        count = int(np.prod(ds.shape)) if ds.shape else 1
        if layout[0] == "compact":
            raw = layout[1]
        elif layout[0] == "contiguous":
            _, addr, n = layout
            if addr == _UNDEF:
                return np.zeros(ds.shape, dt.newbyteorder("="))
            raw = self._r.bytes_at(addr, n or count * dt.itemsize)
        else:   # chunked
            return self._read_chunked(ds, dt, layout, filters)
        arr = np.frombuffer(raw[:count * dt.itemsize], dtype=dt)
        return arr.astype(dt.newbyteorder("=")).reshape(ds.shape)

    def _read_chunked(self, ds, dt, layout, filters):
        _, btree_addr, chunk_dims = layout
        chunk_dims = chunk_dims[:-1]   # last is element size
        out = np.zeros(ds.shape, dt.newbyteorder("="))
        if btree_addr == _UNDEF:
            return out
        chunks = []
        self._walk_chunk_btree(btree_addr, len(chunk_dims), chunks)
        for offsets, addr, nbytes in chunks:
            raw = self._r.bytes_at(addr, nbytes)
            if 1 in filters:   # deflate
                raw = zlib.decompress(raw)
            chunk = np.frombuffer(raw, dtype=dt)
            chunk = chunk[:int(np.prod(chunk_dims))].reshape(chunk_dims)
            sl = tuple(slice(o, min(o + c, s))
                       for o, c, s in zip(offsets, chunk_dims, ds.shape))
            sub = tuple(slice(0, s.stop - s.start) for s in sl)
            out[sl] = chunk[sub]
        return out

    def _walk_chunk_btree(self, addr, rank, out):
        r = self._r
        if r.d[addr:addr + 4] != b"TREE":
            raise H5Error("bad chunk B-tree signature")
        level = r.d[addr + 5]
        entries = r.u(addr + 6, 2)
        pos = addr + 8 + 2 * self._off_size
        key_size = 8 + 8 * (rank + 1)
        for _ in range(entries):
            nbytes = r.u(pos, 4)
            offsets = [r.u(pos + 8 + 8 * i, 8) for i in range(rank)]
            child = r.u(pos + key_size, self._off_size)
            if level > 0:
                self._walk_chunk_btree(child, rank, out)
            else:
                out.append((offsets, child, nbytes))
            pos += key_size + self._off_size
