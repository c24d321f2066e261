"""Build the short_facts corpus artifacts (reference: scripts/fact_dataset.py).

Produces the same artifact set with the same shapes/conventions:
- data/short_facts_contexts.json   (100 fact strings)
- data/short_facts_queries.json    (100 query strings)
- data/short_facts_pairs.json      (100 {fact, query} dicts)
- data/short_facts_embeddings.npy  ((100, hidden) f32, "passage: " prefix,
                                    mean-pooled, L2-normalized)

Embeddings come from our JAX e5 encoder — real HF weights when a local
snapshot exists (WEIGHTS_DIR / HF cache), otherwise the deterministic
architecture-true random init (still a valid retrieval corpus: the encoder
is frozen and shared between corpus build and serving, so rankings are
self-consistent).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# 100 original short fact/query pairs (general knowledge).
FACT_QUERY_PAIRS = [
    {"fact": "Mount Everest rises 8,849 meters above sea level.", "query": "How tall is Mount Everest?"},
    {"fact": "The Pacific Ocean is the largest ocean on Earth.", "query": "Which ocean is the biggest?"},
    {"fact": "Honey never spoils because of its low moisture and high acidity.", "query": "Why doesn't honey go bad?"},
    {"fact": "The Eiffel Tower was completed in 1889 for the World's Fair.", "query": "When was the Eiffel Tower built?"},
    {"fact": "An octopus has three hearts and blue blood.", "query": "How many hearts does an octopus have?"},
    {"fact": "Light takes about eight minutes to travel from the Sun to Earth.", "query": "How long does sunlight take to reach Earth?"},
    {"fact": "The Amazon River carries more water than any other river.", "query": "Which river has the greatest discharge?"},
    {"fact": "Helium is the second most abundant element in the universe.", "query": "What is the second most common element in the universe?"},
    {"fact": "The Mona Lisa was painted by Leonardo da Vinci.", "query": "Who painted the Mona Lisa?"},
    {"fact": "A hummingbird can beat its wings about fifty times per second.", "query": "How fast do hummingbird wings beat?"},
    {"fact": "The Berlin Wall fell in November 1989.", "query": "When did the Berlin Wall come down?"},
    {"fact": "Mercury is the closest planet to the Sun.", "query": "Which planet orbits nearest the Sun?"},
    {"fact": "The human heart beats roughly 100,000 times a day.", "query": "How many times does the heart beat daily?"},
    {"fact": "Antarctica is the driest continent on Earth.", "query": "Which continent is the driest?"},
    {"fact": "The Wright brothers flew the first powered airplane in 1903.", "query": "When was the first powered flight?"},
    {"fact": "Bamboo can grow almost a meter in a single day.", "query": "How fast can bamboo grow?"},
    {"fact": "The Dead Sea is about ten times saltier than the ocean.", "query": "How salty is the Dead Sea?"},
    {"fact": "Venus is the hottest planet in the solar system.", "query": "Which planet is the hottest?"},
    {"fact": "The Great Barrier Reef is the largest living structure on Earth.", "query": "What is the biggest living structure?"},
    {"fact": "Isaac Newton published his laws of motion in 1687.", "query": "When did Newton publish his laws of motion?"},
    {"fact": "A group of lions is called a pride.", "query": "What is a group of lions called?"},
    {"fact": "The Sahara is the largest hot desert in the world.", "query": "What is the biggest hot desert?"},
    {"fact": "Sound travels about 343 meters per second in air.", "query": "How fast does sound travel in air?"},
    {"fact": "The first Olympic Games were held in ancient Greece in 776 BCE.", "query": "Where and when did the Olympics begin?"},
    {"fact": "Sharks existed before trees appeared on Earth.", "query": "Did sharks exist before trees?"},
    {"fact": "The Nile flows northward through eleven countries.", "query": "Which direction does the Nile flow?"},
    {"fact": "Marie Curie won Nobel Prizes in both physics and chemistry.", "query": "Who won Nobel Prizes in two different sciences?"},
    {"fact": "A bolt of lightning is hotter than the surface of the Sun.", "query": "Is lightning hotter than the Sun's surface?"},
    {"fact": "The Moon moves about four centimeters farther from Earth each year.", "query": "Is the Moon drifting away from Earth?"},
    {"fact": "Oxygen makes up about 21 percent of Earth's atmosphere.", "query": "How much of the air is oxygen?"},
    {"fact": "The Titanic sank on its maiden voyage in April 1912.", "query": "When did the Titanic sink?"},
    {"fact": "Kangaroos cannot walk backwards.", "query": "Can kangaroos move backwards?"},
    {"fact": "The Great Wall of China took over two thousand years to build.", "query": "How long did the Great Wall take to build?"},
    {"fact": "Water expands by about nine percent when it freezes.", "query": "Does water expand when frozen?"},
    {"fact": "The cheetah is the fastest land animal, reaching 110 km/h.", "query": "What is the fastest animal on land?"},
    {"fact": "Shakespeare wrote thirty-seven plays and 154 sonnets.", "query": "How many plays did Shakespeare write?"},
    {"fact": "The Andes is the longest mountain range on land.", "query": "What is the longest mountain range?"},
    {"fact": "A day on Venus is longer than its year.", "query": "Is a Venus day longer than its year?"},
    {"fact": "The human brain contains about 86 billion neurons.", "query": "How many neurons are in the brain?"},
    {"fact": "The printing press was invented by Johannes Gutenberg around 1440.", "query": "Who invented the printing press?"},
    {"fact": "Polar bears have black skin under their white fur.", "query": "What color is polar bear skin?"},
    {"fact": "The Mariana Trench is the deepest part of the ocean.", "query": "Where is the ocean deepest?"},
    {"fact": "Albert Einstein received the Nobel Prize for the photoelectric effect.", "query": "What did Einstein win the Nobel Prize for?"},
    {"fact": "Australia is the only country that is also a continent.", "query": "Which country is also a continent?"},
    {"fact": "A blue whale's heart is about the size of a small car.", "query": "How big is a blue whale's heart?"},
    {"fact": "The French Revolution began in 1789.", "query": "When did the French Revolution start?"},
    {"fact": "Butterflies taste with their feet.", "query": "How do butterflies taste food?"},
    {"fact": "Mount Kilimanjaro is the tallest mountain in Africa.", "query": "What is Africa's highest mountain?"},
    {"fact": "The speed of light in vacuum is about 300,000 kilometers per second.", "query": "What is the speed of light?"},
    {"fact": "Vincent van Gogh sold only one painting during his lifetime.", "query": "How many paintings did van Gogh sell while alive?"},
    {"fact": "A leap year occurs every four years to align with Earth's orbit.", "query": "Why do leap years exist?"},
    {"fact": "The Statue of Liberty was a gift from France in 1886.", "query": "Which country gave the Statue of Liberty?"},
    {"fact": "Ants can lift up to fifty times their own body weight.", "query": "How much weight can an ant carry?"},
    {"fact": "The Grand Canyon was carved by the Colorado River.", "query": "Which river carved the Grand Canyon?"},
    {"fact": "Human DNA is about 99.9 percent identical between individuals.", "query": "How similar is DNA between people?"},
    {"fact": "The first computer programmer was Ada Lovelace.", "query": "Who was the first computer programmer?"},
    {"fact": "Jellyfish have survived for over 500 million years without a brain.", "query": "How long have jellyfish existed?"},
    {"fact": "Russia spans eleven time zones.", "query": "How many time zones does Russia cover?"},
    {"fact": "The Louvre in Paris is the most visited museum in the world.", "query": "What is the most visited museum?"},
    {"fact": "Saturn's rings are made mostly of ice particles.", "query": "What are Saturn's rings made of?"},
    {"fact": "The Black Death killed about a third of Europe's population in the 1300s.", "query": "How deadly was the Black Death?"},
    {"fact": "Giraffes sleep less than two hours a day.", "query": "How long do giraffes sleep?"},
    {"fact": "The Panama Canal connects the Atlantic and Pacific Oceans.", "query": "Which oceans does the Panama Canal join?"},
    {"fact": "Gold is so malleable it can be hammered into sheets one atom thick.", "query": "How thin can gold be hammered?"},
    {"fact": "The first email was sent by Ray Tomlinson in 1971.", "query": "When was the first email sent?"},
    {"fact": "Iceland runs almost entirely on renewable energy.", "query": "What powers Iceland's energy grid?"},
    {"fact": "A single teaspoon of neutron star would weigh billions of tons.", "query": "How dense is a neutron star?"},
    {"fact": "The Roman Colosseum could hold about 50,000 spectators.", "query": "How many people fit in the Colosseum?"},
    {"fact": "Bees communicate the location of food through a waggle dance.", "query": "How do bees tell each other where food is?"},
    {"fact": "Lake Baikal holds about a fifth of the world's fresh surface water.", "query": "Which lake holds the most fresh water?"},
    {"fact": "The telephone was patented by Alexander Graham Bell in 1876.", "query": "Who patented the telephone?"},
    {"fact": "Flamingos are pink because of pigments in the shrimp they eat.", "query": "Why are flamingos pink?"},
    {"fact": "The Hubble Space Telescope was launched in 1990.", "query": "When was Hubble launched?"},
    {"fact": "Switzerland has four official languages.", "query": "How many official languages does Switzerland have?"},
    {"fact": "A camel can drink over a hundred liters of water in ten minutes.", "query": "How much water can a camel drink at once?"},
    {"fact": "The Taj Mahal was built as a mausoleum for Mumtaz Mahal.", "query": "Why was the Taj Mahal built?"},
    {"fact": "Earth's inner core is about as hot as the Sun's surface.", "query": "How hot is Earth's core?"},
    {"fact": "The zipper was invented by Whitcomb Judson in 1893.", "query": "Who invented the zipper?"},
    {"fact": "Owls cannot move their eyes, so they rotate their heads instead.", "query": "Why do owls turn their heads so far?"},
    {"fact": "The Suez Canal opened in 1869, linking the Mediterranean and Red Seas.", "query": "When did the Suez Canal open?"},
    {"fact": "Avocados are botanically classified as berries.", "query": "Is an avocado a berry?"},
    {"fact": "The James Webb Space Telescope observes primarily in infrared light.", "query": "What light does the James Webb telescope use?"},
    {"fact": "Norway introduced salmon sushi to Japan in the 1980s.", "query": "Which country brought salmon sushi to Japan?"},
    {"fact": "A single strand of spider silk is stronger than steel of the same weight.", "query": "Is spider silk stronger than steel?"},
    {"fact": "The Treaty of Westphalia in 1648 ended the Thirty Years' War.", "query": "What ended the Thirty Years' War?"},
    {"fact": "Dolphins sleep with one half of their brain at a time.", "query": "How do dolphins sleep?"},
    {"fact": "The metric system was developed in France during the 1790s.", "query": "Where did the metric system originate?"},
    {"fact": "Mushrooms are more closely related to animals than to plants.", "query": "Are mushrooms closer to animals or plants?"},
    {"fact": "The Sydney Opera House took fourteen years to complete.", "query": "How long did the Sydney Opera House take to build?"},
    {"fact": "Greenland is the largest island that is not a continent.", "query": "What is the world's largest island?"},
    {"fact": "The adult human body contains about five liters of blood.", "query": "How much blood is in the human body?"},
    {"fact": "Chess originated in India around the sixth century.", "query": "Where did chess come from?"},
    {"fact": "The ozone layer absorbs most of the Sun's ultraviolet radiation.", "query": "What does the ozone layer do?"},
    {"fact": "Penguins propose to mates by offering a pebble.", "query": "How do penguins choose mates?"},
    {"fact": "The first vaccine, for smallpox, was developed by Edward Jenner in 1796.", "query": "What was the first vaccine?"},
    {"fact": "Tokyo is the most populous metropolitan area in the world.", "query": "What is the largest metropolitan area?"},
    {"fact": "A photon can take thousands of years to escape the Sun's interior.", "query": "How long does light take to leave the Sun?"},
    {"fact": "The Rosetta Stone allowed scholars to decode Egyptian hieroglyphs.", "query": "What unlocked the meaning of hieroglyphs?"},
    {"fact": "Sea otters hold hands while sleeping so they don't drift apart.", "query": "Why do sea otters hold hands?"},
    {"fact": "The Richter scale measuring earthquakes is logarithmic.", "query": "How does the Richter scale work?"},
]

assert len(FACT_QUERY_PAIRS) == 100, len(FACT_QUERY_PAIRS)


def get_passage_embeddings(texts, batch_size: int = 32) -> np.ndarray:
    """Embed passages with the JAX e5 encoder: "passage: " prefix, mean-pool,
    L2-normalize (reference: scripts/fact_dataset.py:185-207)."""
    import jax.numpy as jnp

    from rag_serving_system.config import get_settings
    from rag_serving_system.models import encoder_config_for
    from rag_serving_system.models.e5 import encode
    from rag_serving_system.models.tokenizer import get_tokenizer, HashTokenizer
    from rag_serving_system.models.weights import get_encoder_params

    settings = get_settings()
    cfg = encoder_config_for(settings.model_preset)
    params, real = get_encoder_params(cfg, settings.weights_dir,
                                      settings.embed_model_name)
    tok = (get_tokenizer(settings.embed_model_name, cfg.vocab_size) if real
           else HashTokenizer(cfg.vocab_size, pad_id=cfg.pad_token_id))
    print(f"encoder weights: {'hf' if real else 'deterministic random init'}")

    out = []
    for i in range(0, len(texts), batch_size):
        chunk = [f"passage: {t}" for t in texts[i:i + batch_size]]
        ids, mask = tok.encode_batch(chunk, max_len=512 if real else 64)
        emb = encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask))
        out.append(np.asarray(emb, dtype=np.float32))
    emb = np.concatenate(out, axis=0)
    emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    return emb


def main(out_dir: str = "data") -> None:
    os.makedirs(out_dir, exist_ok=True)
    contexts = [p["fact"] for p in FACT_QUERY_PAIRS]
    queries = [p["query"] for p in FACT_QUERY_PAIRS]

    with open(os.path.join(out_dir, "short_facts_contexts.json"), "w") as f:
        json.dump(contexts, f, indent=1)
    with open(os.path.join(out_dir, "short_facts_queries.json"), "w") as f:
        json.dump(queries, f, indent=1)
    with open(os.path.join(out_dir, "short_facts_pairs.json"), "w") as f:
        json.dump(FACT_QUERY_PAIRS, f, indent=1)

    emb = get_passage_embeddings(contexts)
    np.save(os.path.join(out_dir, "short_facts_embeddings.npy"), emb)
    print(f"wrote {len(contexts)} contexts/queries/pairs + embeddings {emb.shape}")


if __name__ == "__main__":
    main()
