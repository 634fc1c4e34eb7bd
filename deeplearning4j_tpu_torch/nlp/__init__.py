"""NLP: Word2Vec, ParagraphVectors and GloVe over SequenceVectors (and
distributed SequenceVectors and Word2Vec, ``nlp/distributed.py``), the
vocabulary and its Huffman coding, the tokenizer and sentence-iterator
pipeline, WordVectorSerializer, bag-of-words and tf-idf vectorizers, the
BPE tokenizer, the analysis pipeline, constituency trees and the PCFG
parser, and the Japanese and Korean tokenizers: the port of the
reference's ``nlp/`` package."""

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
from deeplearning4j_tpu_torch.nlp.glove import (  # noqa: F401
    AbstractCoOccurrences, Glove)
from deeplearning4j_tpu_torch.nlp.serializer import (  # noqa: F401
    VectorsConfiguration, WordVectorSerializer)
from deeplearning4j_tpu_torch.nlp.vectorizer import (  # noqa: F401
    BagOfWordsVectorizer, TfidfVectorizer)
from deeplearning4j_tpu_torch.nlp.pcfg import Pcfg, PcfgParser  # noqa: F401
from deeplearning4j_tpu_torch.nlp.trees import (  # noqa: F401
    BinarizeTreeTransformer, CollapseUnaries, ContextLabelRetriever,
    HeadWordFinder, Tree, TreeParser, TreeVectorizer)
from deeplearning4j_tpu_torch.nlp.bpe import BpeTokenizer  # noqa: F401
