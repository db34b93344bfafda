"""TriviaQA -> visual-question generation (parity meerqat/data/kilt2vqa.py).

Pipeline: NER placeholder substitution -> NED by word-error-rate against
Wikipedia titles/aliases -> ambiguous-mention generation (pronouns /
man-woman / occupation / instance-of) -> visual question generation with
image heuristics -> Label Studio export -> image download (sharded for
restartability).

The reference drives NER + dependency parsing with spaCy (kilt2vqa.py:
157-227); spaCy is not in this environment, so entity extraction is a
pluggable ``ner_fn`` returning (text, start_char, end_char, label) spans —
plug a spaCy pipeline on a data-prep host, or the built-in
:func:`capitalized_span_ner` fallback. Without a dependency parser the
placeholder replaces the entity span itself (not its syntactic children) —
a documented divergence.
"""
from __future__ import annotations

import json
import re
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from viquae_torch.data import wiki

HUMAN = "http://www.wikidata.org/entity/Q5"
HE_GENDER = {"Q6581097", "Q2449503"}          # male, transgender male
SHE_GENDER = {"Q6581072", "Q1052281"}         # female, transgender female
NA_GENDER = {"Q1097630"}                      # intersex
ANIMAL_SEX = {"Q44148", "Q43445"}             # male/female organism
HE_SHE_DEP = {"nsubj", "nsubjpass"}           # subject deps -> he/she
HIM_HER_DEP = {"dobj", "pobj", "iobj", "dative"}


def map_kilt_triviaqa(cache_dir=None):
    """Join KILT-TriviaQA question ids with the original TriviaQA questions
    (parity data/loading.py:184-210; network-gated: requires the HF hub)."""
    from datasets import load_dataset

    kilt_tasks = load_dataset("kilt_tasks", cache_dir=cache_dir)
    trivia_qa = load_dataset(
        "trivia_qa", "unfiltered.nocontext", cache_dir=cache_dir
    )
    for split in ("train", "validation", "test"):
        qid2row = {
            q_id: i
            for i, q_id in enumerate(trivia_qa[split]["question_id"])
        }
        subset = kilt_tasks[f"{split}_triviaqa"].filter(
            lambda x: x["id"] in qid2row
        )

        def add_missing(x):
            row = trivia_qa[split][qid2row[x["id"]]]
            x["input"] = row["question"]
            x["output"]["original_answer"] = row["answer"]["value"]
            return x

        kilt_tasks[f"{split}_triviaqa"] = subset.map(add_missing)
    return kilt_tasks


# --------------------------------------------------------------------------
# word error rate
# --------------------------------------------------------------------------
def word_error_rate(a: Sequence[str], b: Sequence[str]) -> float:
    """Word-level Levenshtein distance / max length."""
    if not a and not b:
        return 0.0
    m, n = len(a), len(b)
    dist = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        prev = dist.copy()
        dist[0] = i
        for j in range(1, n + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            dist[j] = min(prev[j] + 1, dist[j - 1] + 1, prev[j - 1] + cost)
    return float(dist[n]) / max(m, n)


wer = word_error_rate


# --------------------------------------------------------------------------
# NER placeholder
# --------------------------------------------------------------------------
def capitalized_span_ner(text: str) -> List[Tuple[str, int, int, str]]:
    """Fallback entity extractor: maximal spans of capitalized words
    (optionally joined by 'of/the/de'), skipping the sentence start."""
    spans = []
    pattern = re.compile(
        r"\b[A-Z][\w’']*(?:\s+(?:of|the|de|la|du|von|van|[A-Z][\w’']*))*"
    )
    for match in pattern.finditer(text):
        if match.start() == 0:  # likely just sentence-initial capitalization
            continue
        spans.append((match.group(), match.start(), match.end(), "MISC"))
    return spans


class GazetteerNER:
    """Default entity extractor: longest-match gazetteer over KB titles (+
    aliases) with capitalized-span backoff and determiner-phrase expansion.

    Replaces the reference's spaCy NER + dependency parse
    (meerqat/data/kilt2vqa.py:157-227) for offline use: the KB's
    `wikipedia_title` column IS the closed world the questions mention, so
    a title gazetteer recovers most reference placeholders, and expanding a
    match left over a determiner phrase ("the opera Carmen" -> whole span)
    mimics replacing the entity's syntactic children. Left-edge children of
    other shapes (long appositives) are a documented divergence — plug a
    spaCy `ner_fn` on a data-prep host for full parity.
    """

    # apostrophes join a word only BETWEEN word chars (possessives,
    # contractions, O'Brien) — a trailing ' or ’ is a closing quote and
    # must not leak into the span ("...the poem ‘The Lady of the Lake’?")
    _WORD = re.compile(r"\w+(?:['’]\w+)*")
    _DETERMINERS = {"the", "this", "that", "his", "her", "its", "their"}
    # a preposition boundary ends the determiner phrase: in "the capital of
    # Portugal" the entity's syntactic children do NOT include "the capital"
    _PREPOSITIONS = {"of", "in", "on", "at", "for", "by", "from", "with",
                     "about", "to", "and", "or"}
    # sentence-initial unigram hits are allowed only for non-function words:
    # "Portugal is ..." should fire, "It is what it is" (title "It") and
    # "Help me ..." (title "Help") must not — any capitalized word starts a
    # sentence, so context can't disambiguate common-word titles there
    _FUNCTION_WORDS = {
        "a", "an", "and", "are", "as", "at", "but", "by", "can", "could",
        "did", "do", "does", "for", "from", "had", "has", "have", "he",
        "help", "her", "his", "how", "i", "if", "in", "is", "it", "its",
        "no", "not", "of", "on", "or", "she", "should", "that", "the",
        "these", "they", "this", "those", "to", "was", "we", "were",
        "what", "when", "where", "which", "who", "whom", "whose", "why",
        "will", "would", "yes", "you",
    }
    _POSSESSIVE_SUFFIXES = ("'s", "’s")
    # closed class of nationality/ethnic adjectives (demonyms): the ONLY
    # capitalized words the determiner-phrase expansion may swallow — a dep
    # parse includes "Russian" in the subtree of "the celebrated Russian
    # novel War and Peace" (meerqat/data/kilt2vqa.py:157-227); any other
    # capitalized word may be a distinct entity and must end the phrase.
    # A demonym that is itself a KB title is also excluded at match time.
    _DEMONYMS = frozenset("""
        afghan african albanian algerian american angolan arab arabic
        argentine argentinian armenian asian australian austrian
        azerbaijani bahraini bangladeshi basque bavarian belarusian
        belgian bolivian bosnian brazilian british bulgarian burmese
        byzantine cambodian canadian catalan chilean chinese colombian
        congolese croatian cuban czech danish dominican dutch ecuadorian
        egyptian emirati english estonian ethiopian european filipino
        finnish flemish florentine french galician georgian german
        ghanaian greek guatemalan haitian hispanic honduran hungarian
        icelandic indian indonesian iranian iraqi irish israeli italian
        jamaican japanese jordanian kazakh kenyan korean kurdish kuwaiti
        laotian latin latvian lebanese libyan lithuanian macedonian
        malagasy malaysian maltese mexican moldovan mongolian moroccan
        neapolitan nepalese nicaraguan nigerian nordic norwegian omani
        ottoman pakistani palestinian panamanian paraguayan parisian
        persian peruvian polish portuguese prussian qatari roman romanian
        russian rwandan salvadoran saudi scandinavian scottish senegalese
        serbian sicilian singaporean slovak slovenian somali soviet
        spanish sudanese swedish swiss syrian taiwanese tanzanian thai
        tibetan tunisian turkish ugandan ukrainian uruguayan uzbek
        venetian venezuelan vietnamese welsh yemeni zambian zimbabwean
    """.split())

    def __init__(self, titles, max_ngram: int = 8,
                 expand_determiner_phrase: bool = True,
                 backoff_capitalized: bool = True):
        self.max_ngram = max_ngram
        self.expand = expand_determiner_phrase
        self.backoff = backoff_capitalized
        self.entries: Dict[tuple, str] = {}
        self.first_words: set = set()
        for title in titles:
            words = tuple(
                w.lower() for w in self._WORD.findall(str(title))
            )[: max_ngram]
            if not words:
                continue
            self.entries[words] = str(title)
            self.first_words.add(words[0])

    def _possessive_stripped(self, word: str) -> Optional[str]:
        """'presley's' -> 'presley' (the trailing 's is spaCy's case-marker
        child token, not part of the mention)."""
        for suffix in self._POSSESSIVE_SUFFIXES:
            if word.endswith(suffix) and len(word) > len(suffix):
                return word[: -len(suffix)]
        return None

    def _is_phrase_modifier(self, word: str) -> bool:
        """A token the determiner-phrase expansion may walk over: any
        lowercase word, or a capitalized demonym that is not itself a KB
        title ("the celebrated Russian novel …")."""
        if word.islower():
            return True
        lower = word.lower()
        return lower in self._DEMONYMS and (lower,) not in self.entries

    def __call__(self, text: str) -> List[Tuple[str, int, int, str]]:
        tokens = [(m.group(), m.start(), m.end())
                  for m in self._WORD.finditer(text)]
        lower = [t[0].lower() for t in tokens]
        spans: List[Tuple[str, int, int, str]] = []
        i = 0
        while i < len(tokens):
            matched = None
            possessive_cut = 0
            first_word = lower[i]
            if first_word not in self.first_words:
                # a possessive unigram mention ("Beyoncé's") must still
                # reach the stripped-key lookup below
                stripped_first = self._possessive_stripped(first_word)
                if stripped_first is not None:
                    first_word = stripped_first
            if first_word in self.first_words:
                for n in range(min(self.max_ngram, len(tokens) - i), 0, -1):
                    key = tuple(lower[i: i + n])
                    cut = 0
                    if key not in self.entries:
                        # possessive on the last word: "Marie Curie's
                        # birthplace" mentions the title "Marie Curie"
                        stripped = self._possessive_stripped(key[-1])
                        if stripped is None:
                            continue
                        key = key[:-1] + (stripped,)
                        if key not in self.entries:
                            continue
                        cut = len(lower[i + n - 1]) - len(stripped)
                    # unigram matches must look like a name in context
                    # (capitalized; sentence-initial only for non-function
                    # words) to avoid common-word titles swallowing the
                    # question
                    if n == 1:
                        if not tokens[i][0][0].isupper():
                            continue
                        if (tokens[i][1] == 0
                                and key[0] in self._FUNCTION_WORDS):
                            continue
                    matched = (i, i + n - 1)
                    possessive_cut = cut
                    matched_title = self.entries[key]
                    break
            if matched is None:
                i += 1
                continue
            first, last = matched
            start, end = tokens[first][1], tokens[last][2]
            if self.expand:
                # swallow a preceding determiner phrase of lowercase words:
                # "the opera Carmen" -> the whole phrase, like the
                # reference's left_edge expansion over syntactic children.
                # Case-insensitive and j >= 0 so sentence-initial "The
                # opera Carmen ..." expands too.
                # cap: determiner + up to 3 lowercase modifiers ("the very
                # famous painting Mona Lisa") — a dep parse has no cap, but
                # longer runs risk swallowing clause boundaries
                j = first - 1
                while (j >= 0 and self._is_phrase_modifier(tokens[j][0])
                       and first - j <= 4
                       and tokens[j][0].lower() not in self._DETERMINERS
                       and tokens[j][0].lower() not in self._PREPOSITIONS):
                    j -= 1
                if (j >= 0 and first - j <= 4
                        and tokens[j][0].lower() in self._DETERMINERS):
                    start = tokens[j][1]
            # balance quotes: if the span swallowed an OPENING quote
            # ("the poem ‘The Lady of the Lake’") extend over the closing
            # one so the placeholder doesn't leave a dangling quote —
            # the reference's dep-parse children include both quote tokens
            # (meerqat/data/kilt2vqa.py:205). An opening quote sits at a
            # word boundary (start/space before, word char after) — a
            # possessive apostrophe inside "Sophie's" must not count
            for open_q, close_q in (("'", "'"), ("‘", "’"), ('"', '"')):
                if end < len(text) and text[end] == close_q and re.search(
                    r"(?:^|\s)" + re.escape(open_q) + r"\w",
                    text[start:end],
                ):
                    end += 1
                    break
            # the full span (incl. determiner phrase/quotes) is what the
            # placeholder replaces; the entity itself is the core mention —
            # the reference keeps them separate too (placeholder spans
            # left_edge..right_edge, entity = e.as_doc(),
            # meerqat/data/kilt2vqa.py:205-223) and NED matches titles
            # against the MENTION, not the syntactic children
            # a possessive suffix rides with the placeholder span (it is a
            # child token) but not with the mention NED scores against
            m_start = tokens[first][1]
            m_end = tokens[last][2] - possessive_cut
            spans.append((text[start:end], start, end, matched_title,
                          text[m_start:m_end], m_start, m_end))
            i = last + 1
        if self.backoff:
            for cand in capitalized_span_ner(text):
                if not any(span[1] <= cand[1] < span[2]
                           or span[1] < cand[2] <= span[2]
                           for span in spans):
                    spans.append(cand)
        return sorted(spans, key=lambda s: s[1])


def keep_biggest_spans(spans):
    """Drop spans strictly contained in another (parity with the
    overlapping-mention filter, meerqat/data/kilt2vqa.py:210-222)."""
    out = []
    for span in spans:
        start, end = span[1], span[2]
        included = False
        for other in spans:
            os_, oe = other[1], other[2]
            if (start >= os_ and end < oe) or (start > os_ and end <= oe):
                included = True
                break
        if not included:
            out.append(span)
    return out


def item2placeholder(item: dict,
                     ner_fn: Callable = capitalized_span_ner) -> dict:
    """Replace an explicit entity mention by '{mention}'
    ('Who wrote the opera Carmen?' -> 'Who wrote {mention}?').

    ner_fn spans are (span_text, start, end, label) with an optional
    (mention_text, m_start, m_end) tail when the replaced span is wider
    than the entity mention (determiner-phrase expansion). The placeholder
    cuts the FULL span; the stored entity is the MENTION — the reference's
    split exactly (placeholder spans left_edge..right_edge, entity =
    e.as_doc(); NED then computes WER against the mention,
    meerqat/data/kilt2vqa.py:205-223,299-327)."""
    item["placeholder"] = []
    question = item["input"]
    for span in keep_biggest_spans(ner_fn(question)):
        text, start, end, label = span[:4]
        mention, m_start, m_end = (
            span[4:7] if len(span) > 4 else (text, start, end)
        )
        placeholder = question[:start] + "{mention}" + question[end:]
        item["placeholder"].append({
            "input": placeholder,
            "entity": {"text": mention, "label": label,
                       "start": m_start, "end": m_end},
            "dependency": "",
        })
    return item


# --------------------------------------------------------------------------
# named entity disambiguation
# --------------------------------------------------------------------------
def disambiguate(item: dict, get_wikipedia_item: Callable[[str], dict]) -> dict:
    """Match each placeholder entity against the question's provenance
    articles by minimal WER over title+aliases (kilt2vqa.py:299-327)."""
    for vq in item["placeholder"]:
        mention = vq["entity"]["text"].lower().strip().split()
        provenances = {
            p["wikipedia_id"][0]: re.sub(r"\(.+\)", "", p["title"][0].lower()).strip()
            for p in item["output"]["provenance"]
        }
        wers = {}
        for wid, title in provenances.items():
            aliases = {title}
            wiki_item = get_wikipedia_item(wid)
            aliases.update(
                a.lower().strip()
                for a in wiki_item.get("wikidata_info", {})
                .get("aliases", {}).get("alias", [])
            )
            wers[wid] = min(
                word_error_rate(mention, alias.split()) for alias in aliases
            )
        best = min(wers, key=wers.get)
        wiki_item = get_wikipedia_item(best)
        vq["entity"]["wikidata_info"] = wiki_item.get("wikidata_info", {})
        vq["entity"]["wikipedia_id"] = wiki_item.get("wikipedia_id", best)
        vq["entity"]["wer"] = wers[best]
    return item


def count_entities(dataset, wer_threshold: float = 0.5) -> Dict[str, dict]:
    entities: Dict[str, dict] = {}
    for item in dataset:
        for vq in item["placeholder"]:
            entity = vq["entity"]
            if entity.get("wer", 1.0) > wer_threshold:
                continue
            qid = entity["wikidata_info"].get("wikidata_id")
            if not qid:
                continue
            entities.setdefault(qid, {"n_questions": 0})
            entities[qid]["wikipedia_id"] = entity["wikipedia_id"]
            entities[qid]["n_questions"] += 1
    return entities


# --------------------------------------------------------------------------
# ambiguous mention generation
# --------------------------------------------------------------------------
def generate_mention(item: dict, entities: Dict[str, dict],
                     wer_threshold: float = 0.5,
                     feminine_labels: Optional[dict] = None) -> dict:
    """Generate pronoun / man-woman / occupation / instance-of mentions
    (kilt2vqa.py:378-462)."""
    feminine_labels = feminine_labels or {}
    for vq in item["placeholder"]:
        entity = vq["entity"]
        mentions = {
            "pronouns": [], "man_woman": [], "occupation": [], "instanceof": []
        }
        qid = entity.get("wikidata_info", {}).get("wikidata_id")
        entity_data = entities.get(qid)
        if entity.get("wer", 1.0) > wer_threshold or not entity_data:
            vq["ambiguous_mentions"] = mentions
            continue
        dependency = vq.get("dependency", "")
        gender = entity_data.get("gender", {}).get("value", "")
        gender = gender.split("/")[-1] if gender else gender
        human = HUMAN in entity_data.get("instanceof", {})
        if gender not in ANIMAL_SEX:
            if gender in HE_GENDER:
                mentions["man_woman"].append("this man")
            elif gender in SHE_GENDER:
                mentions["man_woman"].append("this woman")
            if dependency in HE_SHE_DEP:
                if gender in HE_GENDER:
                    mentions["pronouns"].append("he")
                elif gender in SHE_GENDER:
                    mentions["pronouns"].append("she")
            elif dependency in HIM_HER_DEP:
                if gender in HE_GENDER:
                    mentions["pronouns"].append("him")
                elif gender in SHE_GENDER:
                    mentions["pronouns"].append("her")
        occupation = entity_data.get("occupation", {})
        for occ in (
            occupation.values() if isinstance(occupation, dict) else occupation
        ):
            label = occ.get("label", {}).get("value") if isinstance(occ, dict) else occ
            if not label:
                continue
            if gender in SHE_GENDER:
                label = feminine_labels.get(label, label)
            mentions["occupation"].append(f"this {label}")
        if not human:
            instanceof_labels = entity_data.get("instanceofLabel", {})
            for label in (
                instanceof_labels.values()
                if isinstance(instanceof_labels, dict) else instanceof_labels
            ):
                value = label.get("value") if isinstance(label, dict) else label
                if value:
                    mentions["instanceof"].append(f"this {value}")
        vq["ambiguous_mentions"] = mentions
    return item


# --------------------------------------------------------------------------
# visual question generation
# --------------------------------------------------------------------------
def generate_vq(item: dict, entities: Dict[str, dict],
                image_width: int = 512) -> dict:
    """Fill placeholders with ambiguous mentions + attach the entity's best
    image (kilt2vqa.py:497-556)."""
    item["vq"] = []
    for vq in item["placeholder"]:
        mentions = [
            m for kind in vq.get("ambiguous_mentions", {}).values()
            for m in kind
        ]
        if not mentions:
            continue
        qid = vq["entity"].get("wikidata_info", {}).get("wikidata_id")
        entity = entities.get(qid, {})
        title = wiki.best_image(entity)
        if title is None:
            continue
        file_name = title[len("File:"):] if title.startswith("File:") else title
        url = wiki.file_name_to_thumbnail(file_name, image_width=image_width)
        for mention in mentions:
            item["vq"].append({
                "input": vq["input"].format(mention=mention),
                "wikidata_id": qid,
                "image": file_name,
                "url": url,
                "mention": mention,
            })
    return item


def labelstudio_export(items: Sequence[dict], image_width: int = 512
                       ) -> List[dict]:
    """Label Studio task JSON (kilt2vqa.py:621-669)."""
    tasks = []
    for item in items:
        for vq in item.get("vq", []):
            tasks.append({
                "data": {
                    "image": vq["url"],
                    "question": vq["input"],
                    "answer": item["output"]["original_answer"],
                    "original_question": item["input"],
                    "wikidata_id": vq["wikidata_id"],
                    "id": item["id"],
                }
            })
    return tasks


def download_images(items: Sequence[dict], save_root,
                    image_width: int = 512,
                    num_shards: Optional[int] = None,
                    shard_index: Optional[int] = None) -> int:
    """Download vq images (network-gated; sharded for restartability,
    kilt2vqa.py:671-695)."""
    from pathlib import Path

    import requests

    save_root = Path(save_root)
    save_root.mkdir(parents=True, exist_ok=True)
    session = requests.Session()
    n = 0
    for i, item in enumerate(items):
        if num_shards is not None and i % num_shards != (shard_index or 0):
            continue
        for vq in item.get("vq", []):
            target = save_root / vq["image"].replace(" ", "_")
            if target.exists():
                continue
            try:
                response = wiki.request(vq["url"], session)
                target.write_bytes(response.content)
                n += 1
            except (RuntimeError, requests.RequestException) as e:
                # wiki.request raises requests.HTTPError for permanent
                # statuses (deleted Commons files 404 routinely) and
                # RuntimeError after retry exhaustion — warn and keep
                # going so one bad file never aborts (or crash-loops)
                # the whole shard
                warnings.warn(f"{vq['url']}: {e}")
    return n
