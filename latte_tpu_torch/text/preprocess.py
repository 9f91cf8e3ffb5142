"""Caption cleaning for the text encoders: the port's own copy of
``latte_tpu/utils.py``'s ``clean_caption`` and ``text_preprocessing`` (the
PixArt-style cleaning the reference applies before T5).

Lower-cases, unquotes, drops URLs, HTML entities, @handles, CJK blocks,
file names and stray punctuation, unifies dashes and quotes, and collapses
whitespace. Pure ``re``, ``html`` and ``urllib``; the result is
string-equal to the JAX package's (``tests/test_torch_text.py``).
"""

from __future__ import annotations

import html
import re
import urllib.parse as ul

__all__ = ["clean_caption", "text_preprocessing"]

_bad_punct_regex = re.compile(
    r"[" + "#®•©™&@·º½¾¿¡§~" + r"\)" + r"\(" + r"\]" + r"\[" + r"\}" + r"\{" + r"\|" + "\\" + r"\/" + r"\*" + r"]{1,}"
)


def clean_caption(caption: str) -> str:
    caption = str(caption).lower().strip()
    caption = ul.unquote_plus(caption)
    caption = caption.replace("<person>", "person")
    # urls
    caption = re.sub(r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))", "", caption)
    caption = re.sub(r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))", "", caption)
    # html
    caption = html.unescape(html.unescape(caption))
    caption = re.sub(r"@[\w\d]+\b", "", caption)
    # unicode letter blocks
    for pat in (
        r"[\u31c0-\u31ef]+", r"[\u31f0-\u31ff]+", r"[\u3200-\u32ff]+",
        r"[\u3300-\u33ff]+", r"[\u3400-\u4dbf]+", r"[\u4dc0-\u4dff]+",
        r"[\u4e00-\u9fff]+",
    ):
        caption = re.sub(pat, "", caption)
    caption = re.sub(
        r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A\u2E3B\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+",
        "-",
        caption,
    )
    caption = re.sub(r"[`´«»“”¨]", '"', caption)
    caption = re.sub(r"[‘’]", "'", caption)
    caption = re.sub(r"&quot;?", "", caption)
    caption = re.sub(r"&amp", "", caption)
    caption = re.sub(r"\d:\d\d\s+$", "", caption)
    caption = re.sub(r"\\n", " ", caption)
    caption = re.sub(r"#\d{1,3}\b", "", caption)
    caption = re.sub(r"#\d{5,}\b", "", caption)
    caption = re.sub(r"\b\d{6,}\b", "", caption)
    caption = re.sub(r"[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)", "", caption)
    caption = re.sub(r"[\"\']{2,}", r'"', caption)
    caption = re.sub(r"[\.]{2,}", r" ", caption)
    caption = re.sub(_bad_punct_regex, r" ", caption)
    caption = re.sub(r"\s+\.\s+", r" ", caption)
    caption = re.sub(r"(?:\-|\–)", " ", caption)
    caption = re.sub(r"\s+", " ", caption)
    caption = caption.strip()
    caption = re.sub(r"^[\"\']([\w\W]+)[\"\']$", r"\1", caption)
    caption = re.sub(r"^[\'\_,\-\:;]", r"", caption)
    caption = re.sub(r"[\'\_,\-\:\-\+]$", r"", caption)
    caption = re.sub(r"^\.\S+$", "", caption)
    return caption.strip()


def text_preprocessing(text, clean: bool = True) -> str:
    if clean:
        return clean_caption(text)
    return str(text).lower().strip()
