"""WordVectorSerializer, embeddings saved and loaded in several formats:
the port of ``deeplearning4j_tpu/nlp/serializer.py``
(``models/embeddings/loader/WordVectorSerializer.java`` and
``VectorsConfiguration.java``).

- text: a ``"<words> <dim>"`` header, then ``"word v1 v2 ..."`` lines
  with ``%.6f`` values (``writeWordVectors``; ``loadTxtVectors`` reads it
  with or without the header);
- Google's binary word2vec format (``loadGoogleModel:112``): the header,
  then each word, a space, its little-endian f32 vector and a newline;
- the DL4J zip: ``config.json`` (:class:`VectorsConfiguration`),
  ``vocab.json`` (label, frequency, special) and ``syn0.bin``, with
  ``syn1.bin`` (hierarchical softmax) and ``syn1neg.bin`` (negative
  sampling) when the model has them, raw little-endian f32.

The files are the reference's byte for byte, so a file written by either
package reads back in the other to the same vocabulary and vectors. A
loaded model's tables live on ``device`` (None means the card).
"""

from __future__ import annotations

import json
import os
import zipfile
from dataclasses import asdict, dataclass

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import (AbstractCache, Huffman,
                                                VocabWord)

__all__ = ["VectorsConfiguration", "WordVectorSerializer"]


@dataclass
class VectorsConfiguration:
    """``VectorsConfiguration.java``: the hyperparameters a zip keeps."""
    layer_size: int = 100
    window: int = 5
    min_word_frequency: int = 1
    learning_rate: float = 0.025
    min_learning_rate: float = 1e-4
    negative: int = 0
    use_hierarchic_softmax: bool = True
    sampling: float = 0.0
    epochs: int = 1
    seed: int = 123

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "VectorsConfiguration":
        return cls(**json.loads(s))


def _host(t) -> np.ndarray:
    """A table as f32 host numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _table(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


class WordVectorSerializer:
    """The reference class's static API."""

    # ---------------- text ----------------
    @staticmethod
    def write_word_vectors(model: SequenceVectors, path: str) -> None:
        """Plain text: ``"<words> <dim>"``, then ``"word v1 v2 ..."``
        (the Google text format, ``writeWordVectors``)."""
        syn0 = model.lookup_table.all_vectors()
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n")
            for i in range(syn0.shape[0]):
                word = model.vocab.word_at_index(i)
                vec = " ".join(f"{x:.6f}" for x in syn0[i])
                f.write(f"{word} {vec}\n")

    @staticmethod
    def read_word_vectors(path: str, device=None) -> SequenceVectors:
        """Load the Google text format, header optional
        (``loadTxtVectors``)."""
        words, vecs = [], []
        with open(path, "r", encoding="utf-8") as f:
            first = f.readline().split()
            if not (len(first) == 2 and all(t.isdigit() for t in first)):
                words.append(first[0])
                vecs.append([float(x) for x in first[1:]])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                vecs.append([float(x) for x in parts[1:] if x])
        return WordVectorSerializer._assemble(
            words, np.array(vecs, np.float32), device)

    # ---------------- Google binary ----------------
    @staticmethod
    def write_google_binary(model: SequenceVectors, path: str) -> None:
        syn0 = model.lookup_table.all_vectors()
        with open(path, "wb") as f:
            f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n".encode())
            for i in range(syn0.shape[0]):
                f.write(model.vocab.word_at_index(i).encode() + b" ")
                f.write(syn0[i].astype("<f4").tobytes())
                f.write(b"\n")

    @staticmethod
    def read_google_binary(path: str, device=None) -> SequenceVectors:
        """``loadGoogleModel:112``'s binary branch."""
        words, vecs = [], []
        with open(path, "rb") as f:
            header = f.readline().split()
            n, dim = int(header[0]), int(header[1])
            for _ in range(n):
                word = bytearray()
                while True:
                    ch = f.read(1)
                    if ch in (b" ", b""):
                        break
                    word.extend(ch)
                vecs.append(np.frombuffer(f.read(4 * dim), "<f4"))
                words.append(word.decode("utf-8", errors="ignore"))
                nl = f.read(1)
                if nl not in (b"\n", b""):
                    f.seek(-1, os.SEEK_CUR)
        return WordVectorSerializer._assemble(
            words, np.array(vecs, np.float32), device)

    # ---------------- DL4J zip ----------------
    @staticmethod
    def write_word2vec_model(model: SequenceVectors, path: str) -> None:
        """A zip of ``config.json``, ``vocab.json`` (label, frequency,
        special) and ``syn0.bin`` (with ``syn1.bin`` and ``syn1neg.bin``
        when the model has them): ``writeWord2VecModel``'s role."""
        cfg = VectorsConfiguration(
            layer_size=model.layer_size, window=model.window,
            min_word_frequency=model.min_word_frequency,
            learning_rate=model.learning_rate,
            min_learning_rate=model.min_learning_rate,
            negative=model.negative, use_hierarchic_softmax=model.use_hs,
            sampling=model.sampling, epochs=model.epochs, seed=model.seed)
        vocab_rows = [
            {"label": e.label, "frequency": e.element_frequency,
             "special": e.special}
            for e in model.vocab.vocab_words()]
        tbl = model.lookup_table
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("config.json", cfg.to_json())
            z.writestr("vocab.json", json.dumps(vocab_rows))
            z.writestr("syn0.bin", tbl.all_vectors().astype("<f4").tobytes())
            if tbl.syn1 is not None:
                z.writestr("syn1.bin", _host(tbl.syn1).astype("<f4").tobytes())
            if tbl.syn1neg is not None:
                z.writestr("syn1neg.bin",
                           _host(tbl.syn1neg).astype("<f4").tobytes())

    @staticmethod
    def read_word2vec_model(path: str, device=None) -> SequenceVectors:
        with zipfile.ZipFile(path, "r") as z:
            cfg = VectorsConfiguration.from_json(
                z.read("config.json").decode())
            vocab_rows = json.loads(z.read("vocab.json").decode())
            syn0 = np.frombuffer(z.read("syn0.bin"), "<f4").reshape(
                len(vocab_rows), cfg.layer_size).copy()
            syn1 = (np.frombuffer(z.read("syn1.bin"), "<f4")
                    if "syn1.bin" in z.namelist() else None)
            syn1neg = (np.frombuffer(z.read("syn1neg.bin"), "<f4")
                       if "syn1neg.bin" in z.namelist() else None)
        model = SequenceVectors(
            layer_size=cfg.layer_size, window=cfg.window,
            min_word_frequency=cfg.min_word_frequency,
            learning_rate=cfg.learning_rate,
            min_learning_rate=cfg.min_learning_rate,
            negative=cfg.negative,
            use_hierarchic_softmax=cfg.use_hierarchic_softmax,
            sampling=cfg.sampling, epochs=cfg.epochs, seed=cfg.seed,
            device=device)
        dev = model.device
        cache = AbstractCache()
        for row in vocab_rows:
            el = VocabWord(row["label"], row["frequency"])
            el.special = row.get("special", False)
            cache.add_token(el)
            cache.word_for(row["label"]).special = el.special
        cache.update_words_occurrences()
        # the frequency sort can move words: syn0's rows follow the cache
        pos = {r["label"]: i for i, r in enumerate(vocab_rows)}
        order = [pos[cache.word_at_index(k)]
                 for k in range(cache.num_words())]
        model.vocab = cache
        model.lookup_table = InMemoryLookupTable(
            cache.num_words(), cfg.layer_size, seed=cfg.seed,
            use_hs=cfg.use_hierarchic_softmax, negative=cfg.negative,
            device=dev)
        model.lookup_table.syn0 = _table(syn0[order], dev)
        if syn1 is not None and cfg.use_hierarchic_softmax:
            model.lookup_table.syn1 = _table(
                syn1.reshape(-1, cfg.layer_size), dev)
            Huffman(cache.vocab_words()).apply_indexes(cache)
            model._codes, model._points, model._lengths = \
                cache.huffman_arrays()
            model._hs_dev = tuple(
                torch.from_numpy(a.astype(np.int64)).to(dev)
                for a in (model._codes, model._points, model._lengths))
        if syn1neg is not None and cfg.negative > 0:
            model.lookup_table.syn1neg = _table(
                syn1neg.reshape(-1, cfg.layer_size), dev)
            freqs = np.array([e.element_frequency
                              for e in cache.vocab_words()])
            model.lookup_table.build_ns_table(freqs)
        return model

    # ---------------- helpers ----------------
    @staticmethod
    def _assemble(words, syn0: np.ndarray, device=None) -> SequenceVectors:
        model = SequenceVectors(layer_size=syn0.shape[1], device=device)
        cache = AbstractCache()
        # descending pseudo-frequencies keep the file's order through the
        # frequency sort of update_words_occurrences
        for k, w in enumerate(words):
            cache.add_token(VocabWord(w, float(len(words) - k)))
        cache.update_words_occurrences()
        model.vocab = cache
        model.lookup_table = InMemoryLookupTable(
            len(words), syn0.shape[1], use_hs=False, negative=0,
            device=model.device)
        model.lookup_table.syn0 = _table(syn0, model.device)
        return model
