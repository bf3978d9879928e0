from .syllabify import syllabify_word, syllabify_text, abbreviations
from .cantus import clean, combine_transcripts, filename_to_text_func

__all__ = [
    "syllabify_word",
    "syllabify_text",
    "abbreviations",
    "clean",
    "combine_transcripts",
    "filename_to_text_func",
]
