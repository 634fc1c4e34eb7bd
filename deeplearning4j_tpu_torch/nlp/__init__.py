"""NLP: Word2Vec and ParagraphVectors over SequenceVectors, the
vocabulary and its Huffman coding, and the tokenizer and sentence-iterator
pipeline (the reference's ``nlp/`` package; GloVe, the serializers, the
vectorizers, the parsers and the other tokenizers are not ported yet:
ROADMAP.md, queue 1)."""

from deeplearning4j_tpu_torch.nlp.text import (  # noqa: F401
    BasicLineIterator, CollectionSentenceIterator, CommonPreprocessor,
    DefaultTokenizer, DefaultTokenizerFactory, EndingPreProcessor,
    FileSentenceIterator, LabelAwareIterator, LabelledDocument, LabelsSource,
    LowCasePreProcessor, NGramTokenizer, NGramTokenizerFactory,
    SentenceIterator)
from deeplearning4j_tpu_torch.nlp.vocab import (  # noqa: F401
    AbstractCache, Huffman, Sequence, SequenceElement, VocabConstructor,
    VocabWord)
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable  # noqa: F401
from deeplearning4j_tpu_torch.nlp.sequence_vectors import (  # noqa: F401
    CBOW, DBOW, DM, SequenceVectors, SkipGram)
from deeplearning4j_tpu_torch.nlp.word2vec import (  # noqa: F401
    ParagraphVectors, Word2Vec)
